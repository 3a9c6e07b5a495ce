"""Port parity for the GPTQ pipeline, on the CPU.

The port's ``quant/gptq.py``, ``quant/sequential.py``, ``quant/overrides.py``
and ``quant/analysis.py`` against the JAX package on the same numpy inputs.
The JAX solver runs jitted, as the JAX pipeline runs it. Tolerances:
``find_params`` rtol 1e-6 with equal zeros; ``_prepare_hinv`` rel 1e-5; the
solver bit-exact where no error crosses columns (a diagonal H); on dense
problems the integer grid equal (it reads 100% on these problems; JAX's
float32 Cholesky chain and block tails differ from the port's float64 ones
in their last bits, which can move a few entries of wider 8-bit grids) and
loss rel 1e-4;
vit_tiny's sequential GPTQ with per-layer losses rel 1e-3, each layer's
grid on >= 99.9% of its entries and the quantized encoder's output rel L2
<= 1e-3; SNRs within 0.01 dB.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models.configs import VIT_TINY
from sam_quantization_tpu.nn import packed as jpacked
from sam_quantization_tpu.quant import analysis as janalysis
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu.quant import gptq as jgptq
from sam_quantization_tpu.quant import overrides as joverrides
from sam_quantization_tpu.quant import sequential as jseq
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.nn.layers import Linear
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.quant import analysis as tanalysis
from sam_quantization_tpu_torch.quant import artifacts as tart
from sam_quantization_tpu_torch.quant import gptq as tgptq
from sam_quantization_tpu_torch.quant import overrides as toverrides
from sam_quantization_tpu_torch.quant import sequential as tseq

ECFG = VIT_TINY.image_encoder
PATHS = [f"blocks.{i}.{p}" for i in range(ECFG.depth) for p in tseq.BLOCK_PATHS]

_jfind = jax.jit(jgptq.find_params, static_argnums=(1, 2, 3))


def _make_problem(rng, N=32, K=64, B=8, T=16):
    """``tests/test_gptq.py``'s problem: H = (2 / B) Σ_b x_bᵀ x_b."""
    w = rng.normal(size=(N, K)).astype(np.float32)
    xs = rng.normal(size=(B, T, K)).astype(np.float32) * 2.0
    H = np.zeros((K, K), np.float32)
    for b in range(B):
        H += (2.0 / B) * xs[b].T @ xs[b]
    return w, xs, H


def _solve_both(w, H, **kw):
    rj = jgptq.gptq_quantize_matrix(jnp.asarray(w), jnp.asarray(H), **kw)
    rt = tgptq.gptq_quantize_matrix(torch.from_numpy(w), torch.from_numpy(H), **kw)
    return rj, rt


# --------------------------------------------------------------------- solver


@pytest.mark.parametrize("mode", ["plain", "sym", "mse", "sym_mse"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_find_params_matches_jax(rng, bits, mode):
    """Min-max and MSE grid-shrink grids, with an all-zero row (its grid is
    that of [-1, 1])."""
    w = rng.normal(size=(48, 40)).astype(np.float32)
    w[5] = 0.0
    w[7] = np.abs(w[7])  # a row with no negative value
    sym, mse = "sym" in mode, "mse" in mode
    maxq = (1 << bits) - 1
    sj, zj = (np.asarray(a) for a in _jfind(jnp.asarray(w), maxq, sym, mse))
    st, zt = tgptq.find_params(torch.from_numpy(w), maxq, sym, mse)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-6)
    np.testing.assert_array_equal(zt.numpy(), zj)


def test_prepare_hinv_matches_jax(rng):
    """Dead column, damp, Cholesky inverse and upper factor: rel 1e-5."""
    _, _, H = _make_problem(rng, K=64)
    H[:, 9] = H[9, :] = 0.0
    hj = np.asarray(jax.jit(jgptq._prepare_hinv, static_argnums=1)(jnp.asarray(H), 0.01))
    ht = tgptq._prepare_hinv(torch.from_numpy(H), 0.01).numpy()
    assert np.abs(ht - hj).max() <= 1e-5 * np.abs(hj).max()
    np.testing.assert_array_equal(np.tril(ht, -1), 0.0)


# Each option value meets every bit width: (sym, groupsize, actorder, mse).
DIAG_CASES = [(False, -1, False, False), (True, 32, True, True)]


@pytest.mark.parametrize("sym,groupsize,actorder,mse", DIAG_CASES)
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_solver_bit_exact_on_diagonal_hessian(rng, bits, sym, groupsize, actorder, mse):
    """With a diagonal H no error crosses columns, so the port's grid,
    scales, zeros and g_idx equal JAX's bit for bit. Tied diagonal entries
    and a dead column (diag 0) test the stable actorder argsort."""
    N, K = 32, 64
    w = rng.normal(size=(N, K)).astype(np.float32)
    d = rng.uniform(0.5, 3.0, size=K).astype(np.float32)
    d[::5] = d[0]
    d[3] = 0.0
    kw = dict(bits=bits, groupsize=groupsize, sym=sym, actorder=actorder, mse=mse,
              blocksize=32)
    rj, rt = _solve_both(w, np.diag(d), **kw)
    for name in ("q_int", "scales", "zeros", "g_idx"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(float(rt.loss), float(rj.loss), rtol=1e-5)


@pytest.mark.parametrize("bits,groupsize,actorder,sym,N,K", [
    (4, -1, False, False, 32, 64),
    (4, 32, False, False, 32, 64),
    (4, -1, True, False, 32, 64),
    (4, 32, True, False, 32, 64),
    (4, -1, False, True, 32, 64),
    (8, 32, False, False, 128, 128),
])
def test_solver_matches_jax_on_dense_problems(rng, bits, groupsize, actorder, sym, N, K):
    """``tests/test_gptq.py``'s problems (the pack round trip's 128 x 128 as
    well): the grid equal on every entry (measured 100% on each), g_idx
    exact, loss rel 1e-4."""
    w, _, H = _make_problem(rng, N=N, K=K)
    rj, rt = _solve_both(w, H, bits=bits, groupsize=groupsize, actorder=actorder, sym=sym,
                         blocksize=32)
    np.testing.assert_array_equal(rt.q_int.numpy(), np.asarray(rj.q_int))
    np.testing.assert_array_equal(rt.g_idx.numpy(), np.asarray(rj.g_idx))
    np.testing.assert_allclose(float(rt.loss), float(rj.loss), rtol=1e-4)
    np.testing.assert_allclose(rt.scales.numpy(), np.asarray(rj.scales), rtol=1e-5)
    np.testing.assert_allclose(tgptq.reconstruct(rt).numpy(),
                               np.asarray(jgptq.reconstruct(rj, groupsize, K)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [4, 3])
def test_gptq_pack_roundtrip_into_port_linear(rng, bits):
    """Solver -> pack -> the packed linear's plain version, as
    ``test_gptq_pack_roundtrip_into_kernel``; the port packs the same words
    as the JAX package from the same solve."""
    w, _, H = _make_problem(rng, N=128, K=128)
    rj, rt = _solve_both(w, H, bits=bits, groupsize=64, blocksize=64)
    p = tpacked.pack_int_weights(rt.q_int.t(), rt.scales.t(), rt.zeros.t(), None, bits, 64)
    wq_solver = tgptq.reconstruct(rt).t()
    np.testing.assert_allclose(tpacked.dequantize(p).numpy(), wq_solver.numpy(),
                               rtol=1e-5, atol=1e-6)
    x = torch.from_numpy(rng.normal(size=(16, 128)).astype(np.float32))
    np.testing.assert_allclose(tqm.quant_matmul(x, p).numpy(), (x @ wq_solver).numpy(),
                               rtol=1e-4, atol=1e-4)
    pj = jpacked.pack_int_weights(np.asarray(rj.q_int).T, np.asarray(rj.scales).T,
                                  np.asarray(rj.zeros).T, None, bits=bits, groupsize=64)
    np.testing.assert_array_equal(p.qweight.numpy(), np.asarray(pj.qweight))
    if bits == 3:
        np.testing.assert_array_equal(p.qweight_hi.numpy(), np.asarray(pj.qweight_hi))


def test_gptq_groupsize_clamps_to_tiny_K(rng):
    """A layer narrower than the groupsize clamps its group to K, as
    ``test_gptq_groupsize_clamps_to_tiny_K``."""
    K, N = 64, 192
    lin = Linear(K, N, bias=False)
    lin.weight.data.copy_(torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)))
    xs = rng.normal(size=(32, K)).astype(np.float32)
    H = torch.from_numpy(2.0 * (xs.T @ xs) / len(xs) + np.eye(K, dtype=np.float32))
    out, loss = tseq.quantize_linear_gptq(lin, H, tseq.GPTQConfig(bits=4, groupsize=128, sym=True))
    assert isinstance(out, tpacked.PackedLinear) and out.groupsize == K and np.isfinite(loss)
    err = (tpacked.dequantize(out).t() - lin.weight).norm()
    assert err < 0.5 * lin.weight.norm()


# -------------------------------------------------------- sequential encoder


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9))


@pytest.fixture(scope="module")
def setup():
    """``tests/test_quant_pipelines.py``'s vit_tiny (rel-pos tables filled too)
    and three calibration batches, in both packages."""
    rng = np.random.default_rng(0)
    params = jax.jit(lambda k: jie.init(k, ECFG))(jax.random.PRNGKey(0))
    params["pos_embed"] = jnp.asarray(
        rng.normal(size=params["pos_embed"].shape).astype(np.float32) * 0.02)
    for blk in params["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][k] = jnp.asarray(rng.normal(size=blk["attn"][k].shape).astype(np.float32) * 0.2)
    xs = [rng.normal(size=(1, ECFG.img_size, ECFG.img_size, 3)).astype(np.float32)
          for _ in range(3)]
    return params, xs


def _port_encoder(params):
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tbuild.load_jax_encoder(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), tree).image_encoder


def _port_out(encoder, x):
    with torch.no_grad():
        return encoder(torch.from_numpy(x), "eager").numpy()


def _jax_out(params, x):
    return np.asarray(jax.jit(lambda p, x: jie.apply(p, x, ECFG, attn_impl="xla"))(params, x))


def _overrides(mod):
    """Block 1's lin1 at 8 bits, block 2's proj left dense."""
    return mod.QuantOverrides().add("blocks.1.mlp.lin1", bits=8).add("blocks.2.attn.proj", skip=True)


@pytest.fixture(scope="module")
def int4_pair(setup):
    """Both packages' sequential GPTQ W4 g32 with the overrides above."""
    params, xs = setup
    qcfg = dict(bits=4, groupsize=32, blocksize=32)
    jq, jl = jseq.gptq_quantize_encoder(params, ECFG, [jnp.asarray(x) for x in xs],
                                        jgptq.GPTQConfig(**qcfg), overrides=_overrides(joverrides))
    enc, tl = tseq.gptq_quantize_encoder(_port_encoder(params), [torch.from_numpy(x) for x in xs],
                                         tseq.GPTQConfig(**qcfg), overrides=_overrides(toverrides))
    return jq, jl, enc, tl


def test_gptq_encoder_matches_jax(setup, int4_pair):
    """Same layers and losses (rel 1e-3), each packed layer's grid on
    >= 99.9% of its entries within one step (measured 100%), the same layers
    bumped and skipped, and the quantized encoders' outputs within rel. L2
    1e-3 of each other."""
    params, xs = setup
    jq, jl, enc, tl = int4_pair
    assert list(tl) == list(jl) == PATHS
    assert tl["blocks.2.attn.proj"] == jl["blocks.2.attn.proj"] == 0.0
    for k in PATHS:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-3, err_msg=k)
    for k in PATHS:
        i, owner, name = k.split(".")[1:]
        tm, jm = getattr(getattr(enc.blocks[int(i)], owner), name), jq["blocks"][int(i)][owner][name]
        if k == "blocks.2.attn.proj":
            assert isinstance(tm, Linear) and isinstance(jm, dict)
            np.testing.assert_array_equal(tm.weight.numpy().T, np.asarray(jm["w"]))
            continue
        assert tm.bits == jm.bits == (8 if k == "blocks.1.mlp.lin1" else 4)
        qt, qj = tpacked.unpack_to_int(tm).numpy(), np.asarray(jpacked.unpack_to_int(jm))
        assert (qt == qj).mean() >= 0.999 and np.abs(qt - qj).max() <= 1, k
    for x in xs[:1]:
        assert _rel_err(_port_out(enc, x), _jax_out(jq, jnp.asarray(x))) <= 1e-3


def test_gptq_int4_within_rtn(setup):
    """Calibrated GPTQ INT4 no worse than 1.10 x RTN INT4 on the encoder's
    output, as ``test_gptq_int4_better_than_rtn``."""
    params, xs = setup
    fp = _port_out(_port_encoder(params), xs[0])
    qcfg = tseq.GPTQConfig(bits=4, groupsize=32, blocksize=32)
    enc, _ = tseq.gptq_quantize_encoder(_port_encoder(params), [torch.from_numpy(x) for x in xs], qcfg)
    err_gptq = _rel_err(_port_out(enc, xs[0]), fp)
    err_rtn = _rel_err(_port_out(tseq.rtn_quantize_encoder(_port_encoder(params), qcfg), xs[0]), fp)
    assert err_gptq < 0.30
    assert err_gptq <= err_rtn * 1.10, (err_gptq, err_rtn)


def test_gptq_int8_encoder(setup):
    """INT8 is nearly lossless (rel. error < 0.05) and every layer packs, as
    ``test_gptq_sequential_encoder``; the one-subset order works too."""
    params, xs = setup
    fp = _port_out(_port_encoder(params), xs[0])
    for true_sequential in (True, False):
        enc, losses = tseq.gptq_quantize_encoder(
            _port_encoder(params), [torch.from_numpy(x) for x in xs],
            tseq.GPTQConfig(bits=8, groupsize=32, blocksize=32), true_sequential=true_sequential)
        assert list(losses) == PATHS and all(np.isfinite(v) for v in losses.values())
        assert all(isinstance(m, tpacked.PackedLinear) for m in tanalysis._block_linears(enc).values())
        assert _rel_err(_port_out(enc, xs[0]), fp) < 0.05


def test_gptq_actorder_layers_stay_dense(setup):
    """With actorder every layer keeps dense fake-quant weights (the groups
    follow the permuted order), each on the 4-bit grid of its group."""
    params, xs = setup
    fp = _port_out(_port_encoder(params), xs[0])
    enc, losses = tseq.gptq_quantize_encoder(
        _port_encoder(params), [torch.from_numpy(x) for x in xs[:2]],
        tseq.GPTQConfig(bits=4, groupsize=32, blocksize=32, actorder=True))
    layers = tanalysis._block_linears(enc)
    assert all(type(m) is Linear for m in layers.values())
    w = layers["blocks.0.mlp.lin1"].weight  # (N, K): at most 16 levels per row and group
    assert max(len(torch.unique(w[n])) for n in range(8)) <= 16 * (w.shape[1] // 32)
    assert _rel_err(_port_out(enc, xs[0]), fp) < 0.30


# ------------------------------------------------------- overrides, analysis


def test_overrides_match_roundtrip_and_bump_equal_jax():
    snrs = {p: float(v) for p, v in zip(PATHS, np.random.default_rng(3).uniform(5, 40, len(PATHS)))}
    for mod in (toverrides, joverrides):
        ov = mod.QuantOverrides()
        ov.add("blocks.*.mlp.*", bits=8)
        ov.add("blocks.3.mlp.lin2", skip=True, groupsize=16)
        assert ov.match("blocks.0.mlp.lin1").bits == 8
        assert ov.match("blocks.0.attn.qkv") is None
        hit = ov.match("blocks.3.mlp.lin2")
        assert hit.skip and hit.bits == 8 and hit.groupsize == 16
    t, j = _overrides(toverrides), _overrides(joverrides)
    assert t.to_json() == j.to_json()
    back = toverrides.QuantOverrides.from_json(j.to_json())
    assert [(p, dataclasses.asdict(o)) for p, o in back.rules] == \
        [(p, dataclasses.asdict(o)) for p, o in j.rules]
    for kw in ({"k": 4, "bits": 8}, {"k": 3, "skip": True}, {"k": 10, "min_snr_db": 15.0}):
        bt = toverrides.QuantOverrides.bump_worst_snr(snrs, **kw)
        bj = joverrides.QuantOverrides.bump_worst_snr(snrs, **kw)
        assert bt.to_json() == bj.to_json() and len(bt.rules) == len(bj.rules) > 0


def test_graphwise_and_layerwise_snr_match_jax(setup, tmp_path):
    """A JAX-quantized RTN W2 encoder (groups of 32) loaded in the port: the
    same keys (every linear and conv; layerwise the 16 block linears) and
    SNRs within 0.01 dB; the port's RTN with the worst layers bumped to 8
    bits reads a better SNR at the encoder's output."""
    params, xs = setup
    qj = jseq.rtn_quantize_encoder(params, jgptq.GPTQConfig(bits=2, groupsize=32))
    jart.save_quantized(str(tmp_path), qj, {"method": "rtn", "wbits": 2, "groupsize": 32})
    fp = _port_encoder(params)
    qt = tbuild.load_jax_encoder(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"),
                                 tart.load_quantized(str(tmp_path))[0]).image_encoder
    batches = [xs[0]]
    gj = janalysis.graphwise_error_analyse(params, qj, ECFG, [jnp.asarray(x) for x in batches])
    gt = tanalysis.graphwise_error_analyse(fp, qt, [torch.from_numpy(x) for x in batches])
    assert list(gt) == ["patch_embed", *PATHS, "neck.conv1", "neck.conv2"]
    assert sorted(gt) == sorted(gj)
    lj = janalysis.layerwise_error_analyse(params, qj, ECFG, [jnp.asarray(x) for x in batches])
    lt = tanalysis.layerwise_error_analyse(fp, qt, [torch.from_numpy(x) for x in batches])
    assert sorted(lt) == sorted(lj) == sorted(PATHS)
    for got, want in ((gt, gj), (lt, lj)):
        for k in want:
            assert abs(got[k] - want[k]) <= 0.01, (k, got[k], want[k])
    assert "SNR" in tanalysis.format_report(gt)

    ov = toverrides.QuantOverrides.bump_worst_snr(lt, k=4, bits=8)
    qcfg = tseq.GPTQConfig(bits=2, groupsize=32)
    mixed = tseq.rtn_quantize_encoder(_port_encoder(params), qcfg, overrides=ov)
    assert tanalysis._block_linears(mixed)[ov.rules[0][0]].bits == 8
    base = tseq.rtn_quantize_encoder(_port_encoder(params), qcfg)
    ref = torch.from_numpy(_port_out(fp, xs[0]))
    snr_base = float(tanalysis.snr_db(ref, torch.from_numpy(_port_out(base, xs[0]))))
    snr_mixed = float(tanalysis.snr_db(ref, torch.from_numpy(_port_out(mixed, xs[0]))))
    assert snr_mixed > snr_base + 1.0, (snr_base, snr_mixed)
