"""Port parity for int8-activation (W-A8) serving, on the CPU.

The same inputs and integer grids, drawn with numpy from a seed, go through
the JAX package and the port. The per-token quantization is compared bit for
bit; the plain versions of the two W-A8 kernels are held against the JAX
Pallas kernels in interpret mode (``quant_matmul.INTERPRET``, as
``tests/test_packed.py`` runs them), the XLA paths against their JAX
counterparts, and a JAX-written ``act_bits = 8`` artifact is served by both.
Tolerances are stated where they are used.
"""

import dataclasses
import io
import json
import pathlib
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.nn import packed as jpacked
from sam_quantization_tpu.ops import fused_mlp as jfused
from sam_quantization_tpu.ops import quant_matmul as jqm
from sam_quantization_tpu.predictor import SamPredictor as JPredictor
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu.quant import gptq as jgptq
from sam_quantization_tpu.quant import sequential as jseq
from sam_quantization_tpu.train import checkpoint as ckpt_lib
from sam_quantization_tpu.train import trainer
from sam_quantization_tpu_torch.cli import infer as tinfer
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.ops import fused_mlp as tfused
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.predictor import SamPredictor as TPredictor
from sam_quantization_tpu_torch.quant import artifacts as tart
from sam_quantization_tpu_torch.quant import sequential as tseq

CKPT = pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "vit_tiny_synth"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_packed(jp) -> tpacked.PackedLinear:
    """The port's PackedLinear holding a JAX PackedLinear's words and fields."""
    f = {fl.name: getattr(jp, fl.name) for fl in dataclasses.fields(jp)}
    p = tpacked.PackedLinear(f["in_features"], f["out_features"], bits=f["bits"],
                             groupsize=f["groupsize"], pack_block=f["pack_block"],
                             bias=f["bias"] is not None, act_bits=f["act_bits"], sym=f["sym"])
    for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
        if f[k] is not None:
            getattr(p, k).copy_(torch.from_numpy(np.array(f[k])))
    return p


def _layer(seed, K, N, bits, g, sym, bias=False):
    """A JAX RTN layer with int8 activations and its port twin. Asymmetric
    grids are drawn on skewed weights (zero points far from the middle)."""
    r = np.random.default_rng(seed)
    w = r.normal(size=(K, N)).astype(np.float32) * 0.05 + (0.0 if sym else 0.08)
    b = jnp.asarray(r.normal(size=(N,)).astype(np.float32) * 0.01) if bias else None
    jp = jpacked.quantize_rtn(jnp.asarray(w), bits, g, sym, bias=b)
    jp = dataclasses.replace(jp, act_bits=8)
    return jp, _port_packed(jp)


def _x(seed, M, K, dtype="f32"):
    x = np.random.default_rng(seed).normal(size=(M, K)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(out, ref, dtype):
    """float32: |d| <= 1e-5 max|ref| (the integer sums are exact on both
    sides; the float32 epilogue may group the K tiles differently);
    bfloat16: one output step more, |d| <= 2**-7 |ref| + 1e-5 max|ref|."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    bound = (2.0**-7 * np.abs(ref) if dtype == "bf16" else 0.0) + 1e-5 * np.abs(ref).max()
    d = np.abs(out - ref)
    assert (d <= bound).all(), (d.max(), float((d - bound).max()))


def _interpret(fn, *args):
    jqm.INTERPRET = True
    try:
        return np.asarray(fn(*args).astype(jnp.float32))
    finally:
        jqm.INTERPRET = False


# ---------------------------------------------------------------------------
# (a) per-token quantization, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_int8_is_bit_exact(dtype):
    """Equal int8 values and equal scales, including an all-zero row (scale
    1e-8/127, zeros) and half-way points (x / scale = 0.5, 1.5, 2.5 round to
    even)."""
    r = np.random.default_rng(0)
    x = (r.normal(size=(37, 96)) * r.uniform(0.01, 30, size=(37, 1))).astype(np.float32)
    x[3] = 0.0
    x[5, :5] = [127.0, 0.5, 1.5, -2.5, 3.5]
    x[5, 5:] = 0.25
    jx, tx = (jnp.asarray(x, DTYPES[dtype][0]), torch.from_numpy(x).to(DTYPES[dtype][1]))
    jq, js = jqm.quantize_activations_int8(jx)
    tq, ts = tqm.quantize_activations_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (37, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq[3] == 0).all() and float(ts[3, 0]) == np.float32(np.float32(1e-8) / np.float32(127))
    assert tq[5, :5].tolist() == [127, 0, 2, -2, 4]


# ---------------------------------------------------------------------------
# (b) the kernels' plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("groupsize", [0, 32, 128])
def test_a8_plain_matches_jax_kernel(dtype, sym, bits, groupsize):
    """M 100 (ragged: the Pallas wrapper pads to its block), K 512, N 256
    (the Pallas wrapper takes N in multiples of 128)."""
    jp, tp = _layer(bits * 10 + groupsize, 512, 256, bits, groupsize, sym)
    jx, tx = _x(groupsize + bits, 100, 512, dtype)
    jfn = jqm._quant_matmul_a8_sym if sym else jqm._quant_matmul_a8_asym
    ref = _interpret(jfn, jx, jp)
    xq, xs = tqm.quantize_activations_int8(tx)
    out = tqm.a8_matmul_plain(xq, xs, tp, tx.dtype, sym)
    assert out.dtype == tx.dtype
    _close(out, ref, dtype)
    before = dict(tqm.LAUNCHES)
    wrapper = tqm.quant_matmul_a8_sym if sym else tqm.quant_matmul_a8
    assert torch.equal(wrapper(tx, tp), out)
    assert torch.equal(tqm.quant_matmul(tx, tp), out)
    assert tqm.LAUNCHES == before  # a CPU tensor takes the plain version, no launch


def test_a8_plain_matches_jax_w8_asym_regression():
    """``test_packed.py::test_quant_matmul_a8_w8_asym``'s case: 8-bit grid
    values up to 255 must be shifted by 128 before the int8 narrowing, not
    wrapped. Tolerance as above; the zero points are far from 128."""
    jp, tp = _layer(7, 256, 128, 8, 128, sym=False)
    assert float(np.abs(np.asarray(jp.zeros) - 128).max()) > 50
    jx, tx = _x(8, 64, 256)
    ref = _interpret(jqm.quant_matmul_a8_pallas, jx, jp)
    _close(tqm.quant_matmul(tx, tp), ref, "f32")
    # and the int8-activation error alone is small against the weight-only product
    w4 = _np(tqm.quant_matmul_plain(tx, tp))
    assert np.linalg.norm(ref - w4) / np.linalg.norm(w4) < 0.02


# ---------------------------------------------------------------------------
# (c) the XLA paths (3-bit W-A8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("groupsize", [0, 32])
def test_a8_xla_paths_match_jax(bits, groupsize):
    """``quant_matmul_a8_xla`` (float32 sums of xq times the dequantized
    weight) and ``quant_matmul_a8_sym_native`` (exact integer dots per group)
    against JAX's, float32, |d| <= 1e-5 max|ref|: the sums run in another
    order."""
    jx, tx = _x(bits + groupsize, 50, 256)
    ja, ta = _layer(bits + 1, 256, 128, bits, groupsize, sym=False)
    _close(tqm.quant_matmul_a8_xla(tx, ta), jqm.quant_matmul_a8_xla(jx, ja), "f32")
    js, ts = _layer(bits + 2, 256, 128, bits, groupsize, sym=True)
    _close(tqm.quant_matmul_a8_sym_native(tx, ts), jqm.quant_matmul_a8_sym_native(jx, js), "f32")
    if bits == 3:  # quant_matmul takes them for 3-bit W-A8 layers, as JAX does
        _close(tqm.quant_matmul(tx, ta), jqm.quant_matmul_a8_pallas(jx, ja), "f32")
        _close(tqm.quant_matmul(tx, ts), jqm.quant_matmul_a8_pallas(jx, js), "f32")


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,K,groupsize", [(4, 64, 16), (8, 96, 4), (2, 288, 144)])
def test_a8_groups_below_the_k_step_match_jax_kernel(sym, bits, K, groupsize):
    """Layers whose groups end inside the W-A8 kernels' 32-deep k steps (a
    4-bit layer at groupsize 16, 4 at 8 bits, and 144, a group across the
    128-row K tiles), x (5, K), N 128: ``quant_matmul`` takes the W-A8
    kernel's route (its plain version on the CPU), held against JAX's Pallas
    kernels in interpret mode, float32, |d| <= 1e-5 max|ref| (``_close``)."""
    jp, tp = _layer(16 + sym + bits, K, 128, bits, groupsize, sym)
    jx, tx = _x(17, 5, K)
    ref = _interpret(jqm.quant_matmul_a8_pallas, jx, jp)
    out = tqm.quant_matmul(tx, tp)
    assert out.shape == (5, 128) and tp.groupsize == groupsize
    _close(out, ref, "f32")
    kernel = tqm.quant_matmul_a8_sym if sym else tqm.quant_matmul_a8
    assert torch.equal(out, kernel(tx, tp))


# ---------------------------------------------------------------------------
# (c') the integer algebra of the kernels' tensor-core build
# ---------------------------------------------------------------------------

MAGIC = 0x4B400000  # the bits of 1.5 * 2**23


def _u8_form(xq, xs, p, dtype, sym):
    """What the main build of ``csrc/quant_matmul_a8.cu`` computes: the raw
    grid values w (u8, nothing subtracted), per segment the int32 sum d =
    xq.w - sub * rowsum(xq), the same integer as xq.(w - sub), turned into
    float32 through the bits of 1.5 * 2**23 + d (no conversion), then the
    plain version's float32 fold, token scale and cast."""
    sub = tqm.a8_offset(p.bits, sym)
    w = tpacked.unpack_to_int(p).to(torch.int64)
    assert 0 <= int(w.min()) and int(w.max()) < 256  # u8 operands
    xl = xq.to(torch.int64)
    acc = torch.zeros((xq.shape[0], p.out_features), dtype=torch.float32)
    for a, b in tqm.a8_segments(p.in_features, p.groupsize, p.pack_block):
        g = a // p.groupsize
        rs = xl[:, a:b].sum(dim=1, keepdim=True)
        d = xl[:, a:b] @ w[a:b] - sub * rs
        assert int(d.abs().max()) < 2**22  # where the magic-number conversion is exact
        dv = (d + MAGIC).to(torch.int32).view(torch.float32) - 1.5 * 2**23
        if sym:
            term = dv * p.scales[g]
        else:
            term = (dv - (p.zeros[g] - sub) * rs.to(torch.float32)) * p.scales[g]
        acc = acc + term
    return (acc * xs).to(dtype)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("groupsize", [32, 64, 128])
@pytest.mark.parametrize("K", [384, 1280])
def test_a8_u8_form_matches_plain_and_jax_kernel(sym, bits, groupsize, K):
    """The tensor-core build's decomposition against the plain version, bit
    for bit (float32 and bfloat16), and in float32 against JAX's Pallas
    kernel in interpret mode, whose K tiles hold whole groups here, so its
    segments are the port's: |d| <= 1e-5 max|ref| (``_close``), because
    XLA on the CPU rounds the fold's float32 arithmetic differently (about
    half the outputs move by an ulp). x (37, K) with one row of extreme
    values (+-127 in every column), N 128; asymmetric grids on skewed
    weights, zero points far from the middle (at 8 bits from 128)."""
    jp, tp = _layer(bits * 100 + groupsize + K, K, 128, bits, groupsize, sym)
    x = np.random.default_rng(K + groupsize).normal(size=(37, K)).astype(np.float32)
    x[5] = np.where(np.arange(K) % 3 == 0, -1.0, 1.0)  # xq row of +-127: the largest |d|
    xq, xs = tqm.quantize_activations_int8(torch.from_numpy(x))
    for dtype in (torch.float32, torch.bfloat16):
        out = _u8_form(xq, xs, tp, dtype, sym)
        assert torch.equal(out, tqm.a8_matmul_plain(xq, xs, tp, dtype, sym))
    jfn = jqm._quant_matmul_a8_sym if sym else jqm._quant_matmul_a8_asym
    ref = _interpret(jfn, jnp.asarray(x), jp)
    _close(_u8_form(xq, xs, tp, torch.float32, sym), ref, "f32")


# ---------------------------------------------------------------------------
# (d) the dispatch table, (e) with_act_bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,sym,groupsize,act_bits,want", [
    (4, True, 0, 8, "quant_matmul_a8_sym"),   # one group: JAX on a TPU takes XLA here
    (4, True, 32, 8, "quant_matmul_a8_sym"),
    (2, True, 128, 8, "quant_matmul_a8_sym"),
    (8, True, 32, 8, "quant_matmul_a8_sym"),
    (4, False, 32, 8, "quant_matmul_a8"),
    (8, False, 0, 8, "quant_matmul_a8"),
    (3, True, 32, 8, "quant_matmul_a8_sym_native"),
    (3, False, 32, 8, "quant_matmul_a8_xla"),
    (4, True, 16, 8, "quant_matmul_a8_sym"),  # groups end inside the kernels' k steps
    (4, False, 16, 8, "quant_matmul_a8"),
    (4, True, 32, 0, "quant_matmul_plain"),   # weight-only: the W4A16 path
    (3, False, 0, 0, "quant_matmul_plain"),
])
def test_quant_matmul_dispatch(monkeypatch, bits, sym, groupsize, act_bits, want):
    seen = []
    for name in ("quant_matmul_a8_sym", "quant_matmul_a8", "quant_matmul_a8_sym_native",
                 "quant_matmul_a8_xla", "quant_matmul_plain"):
        monkeypatch.setattr(tqm, name, lambda x, p, name=name: seen.append(name))
    _, tp = _layer(1, 128, 64, bits, groupsize, sym)
    tp.act_bits = act_bits
    tqm.quant_matmul(torch.zeros(4, 128), tp)
    assert seen == [want]


def test_with_act_bits_leaves_its_input_unchanged():
    model = tsam.init(TCONFIGS["vit_tiny"], 0, "cpu")
    enc = tseq.rtn_quantize_encoder(model.image_encoder, tseq.GPTQConfig(4, 32, sym=True))
    a8 = tpacked.with_act_bits(enc, 8)
    packed = [m for m in enc.modules() if isinstance(m, tpacked.PackedLinear)]
    copied = [m for m in a8.modules() if isinstance(m, tpacked.PackedLinear)]
    assert len(packed) == len(copied) == 4 * len(enc.blocks)
    assert all(m.act_bits == 0 for m in packed) and all(m.act_bits == 8 for m in copied)
    # the copy shares the tensors, as JAX's dataclasses.replace shares arrays
    assert copied[0].qweight.data_ptr() == packed[0].qweight.data_ptr()
    assert a8.blocks[0].norm1.weight.data_ptr() == enc.blocks[0].norm1.weight.data_ptr()
    one = tpacked.with_act_bits(packed[0], 8)
    assert one.act_bits == 8 and packed[0].act_bits == 0
    assert tpacked.with_act_bits(a8, 0).blocks[0].attn.qkv.act_bits == 0


# ---------------------------------------------------------------------------
# (f) a JAX-written act_bits = 8 artifact, (g) the MLP fallback
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def a8_artifact(tmp_path_factory):
    """The committed vit_tiny checkpoint, RTN symmetric W4 g32 with int8
    activations on every block linear, written by the JAX package."""
    cfg = JCONFIGS["vit_tiny"]
    template = jsam.init(jax.random.PRNGKey(0), cfg)
    opt_t = trainer.make_optimizer(trainer.TrainConfig()).init(template)
    jm, _, _ = ckpt_lib.load_checkpoint(str(CKPT), template, opt_t, "best")
    jm = jax.tree_util.tree_map(jnp.asarray, jm)
    qcfg = jgptq.GPTQConfig(bits=4, groupsize=32, sym=True)
    qp = jax.jit(lambda p: jseq.rtn_quantize_encoder(p, qcfg))(jm.image_encoder)
    d = str(tmp_path_factory.mktemp("a8") / "a8")
    jart.save_quantized(d, jpacked.with_act_bits(qp, 8),
                        {"method": "rtn", "wbits": 4, "groupsize": 32, "sym": True})
    return jm, d


def test_a8_artifact_serves_like_jax(a8_artifact, tmp_path, monkeypatch):
    """The port loads the artifact (every block linear keeps act_bits 8 and
    runs the symmetric W-A8 plain version), writes it back unchanged, and
    its vit_tiny predictor matches JAX's on the same artifact (JAX's CPU
    path is ``quant_matmul_a8_xla``), float32. Embedding, low_res and iou
    atol 1e-4: the two sum the same integers in another form and order (a
    float32 dot of dequantized weights against exact integer dots scaled
    per group). A 1-ulp difference before a linear could move a value
    across an int8 rounding point and that product by one activation step;
    on this input none does."""
    jm, d = a8_artifact
    enc, qcfg = jart.load_quantized(d)
    jq = jsam.Sam(image_encoder=enc, prompt_encoder=jm.prompt_encoder,
                  mask_decoder=jm.mask_decoder, config=jm.config)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    sd = tbuild.from_jax_params(to_np(jm.image_encoder), to_np(jm.prompt_encoder),
                                to_np(jm.mask_decoder), JCONFIGS["vit_tiny"])
    tmodel = tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)
    tenc, tcfg = tart.load_quantized(d)
    assert tcfg == qcfg
    tbuild.load_jax_encoder(tmodel, tenc)
    for blk in tmodel.image_encoder.blocks:
        for owner, name in BLOCK_LINEARS:
            p = getattr(getattr(blk, owner), name)
            assert isinstance(p, tpacked.PackedLinear) and (p.act_bits, p.sym) == (8, True)

    # round trip: the port's tree holds the JAX tree's fields and words
    tree = tbuild.to_jax_encoder(tmodel.image_encoder)
    back = str(tmp_path / "back")
    tart.save_quantized(back, tree, qcfg)
    enc2, _ = jart.load_quantized(back)
    for i, blk in enumerate(enc["blocks"]):
        for owner, name in BLOCK_LINEARS:
            a, b = blk[owner][name], enc2["blocks"][i][owner][name]
            assert (b.act_bits, b.sym, b.bits, b.groupsize) == (a.act_bits, a.sym, a.bits,
                                                               a.groupsize)
            np.testing.assert_array_equal(np.asarray(b.qweight), np.asarray(a.qweight))
            np.testing.assert_array_equal(np.asarray(b.scales), np.asarray(a.scales))

    calls = []
    real = tqm.a8_matmul_plain
    monkeypatch.setattr(tqm, "a8_matmul_plain",
                        lambda *a, **k: calls.append(a[-1]) or real(*a, **k))
    image = np.random.default_rng(21).integers(0, 256, (150, 200, 3), dtype=np.uint8)
    jp, tp = JPredictor(jq), TPredictor(tmodel)
    jemb, temb = _np(jp.set_image(image)), _np(tp.set_image(image))
    assert calls == [True] * 4 * len(tmodel.image_encoder.blocks)  # every linear, symmetric
    np.testing.assert_allclose(temb, jemb, atol=1e-4)
    pts, labels = np.array([[100.0, 60.0], [40.0, 120.0]], np.float32), np.array([1.0, 0.0])
    _, ji, jl = jp.predict(pts, labels, return_logits=True)
    _, ti, tl = tp.predict(pts, labels, return_logits=True)
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    np.testing.assert_allclose(ti, ji, atol=1e-4)


def test_cli_infer_serves_a8_artifact_on_cpu(a8_artifact, monkeypatch):
    """``cli.infer --load DIR --benchmark`` on the W-A8 artifact runs every
    block linear through the symmetric W-A8 path (its plain version here)."""
    _, d = a8_artifact
    calls = []
    real = tqm.a8_matmul
    monkeypatch.setattr(tqm, "a8_matmul", lambda *a, **k: calls.append(k["sym"]) or real(*a, **k))
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tinfer.main(["vit_tiny", "--load", d, "--benchmark", "--bench-iters", "1",
                          "--bench-warmup", "0", "--platform", "cpu"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and out["encoder_s_per_image"] > 0
    assert calls == [True] * 4 * TCONFIGS["vit_tiny"].image_encoder.depth


@pytest.mark.parametrize("bits,act_bits", [(4, 8), (3, 8), (3, 0)])
def test_fused_mlp_fallback_matches_jax(bits, act_bits):
    """A pair that fails fused_mlp_supported runs JAX's unfused sequence
    (quant_matmul, bias, erf GELU in float32, quant_matmul, bias), float32.
    The weight-only 3-bit pair: |d| <= 1e-5 max|ref| (float32 sums in
    another order). W-A8 pairs: JAX on the CPU runs quant_matmul_a8_xla,
    the port the W-A8 plain version (4-bit) or the exact integer dots of
    quant_matmul_a8_sym_native (3-bit): |d| <= 2e-3 max|ref| (see the
    artifact test: an int8 rounding point can fall between the two hidden
    activations)."""
    K, H = 128, 512
    j1, t1 = _layer(30 + bits, K, H, bits, 32, sym=True, bias=True)
    j2, t2 = _layer(31 + bits, H, K, bits, 32, sym=True, bias=True)
    j1, j2 = (dataclasses.replace(j, act_bits=act_bits) for j in (j1, j2))
    t1.act_bits = t2.act_bits = act_bits
    assert not jfused.fused_mlp_supported(j1, j2) and not tfused.fused_mlp_supported(t1, t2)
    jx, tx = _x(32, 3 * 24, K)
    ref = np.asarray(jfused.fused_mlp(jx.reshape(3, 24, K), j1, j2))
    out = tfused.fused_mlp(tx.reshape(3, 24, K), t1, t2)
    assert out.shape == (3, 24, K)
    peak = np.abs(ref).max()
    tol = 2e-3 if act_bits == 8 else 1e-5
    np.testing.assert_array_less(np.abs(_np(out) - ref), tol * peak + 1e-30)
