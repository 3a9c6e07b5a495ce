"""Port parity of FQ-ViT's building blocks, on the CPU: bit types, the
uniform and log2 quantizers, the integer ops (``get_mn``, integer LayerNorm,
i-exp softmax, Log-Int-Softmax), the observers and the weight quantizer,
against the JAX package on the same numpy inputs.

The JAX package runs its observers inside its jitted calibration step, so
they run jitted here too; the integer ops and the weight quantizer run
eagerly in its quant mode and offline, so they run eagerly (the integer
ops also jitted, with the same results). Tolerances:

* bit types, uniform quantizers, ``get_mn``, ``log_round``, integer
  LayerNorm, i-exp numerators, LIS, observer states and minmax / ema /
  percentile params, ``weight_params``: bit-equal, values at rounding ties
  and powers of two included. The integer LayerNorm's inputs keep its sums
  exact integers in float32 (C 64), as they are at SAM's LN widths only when
  the sum of squares stays below 2^24;
* i-exp denominators: rel 1e-6 (float32 sums of integers past 2^24, in
  another order);
* ``log2_fake_quant``: bit-equal on random values and at powers of two; near
  the ties of ``round(-log2 x)`` (x within 200 ulps of 2^-(k + 1/2)) XLA's
  own ``logf`` and the C library's differ by an ulp, which flips 3 of the
  8,020 values (measured): bound 1 in 1,000 there;
* omse and ptf: the same chosen candidate on every channel; scales then rel
  1e-6 (measured equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.quant import bit_type as jbt
from sam_quantization_tpu.quant import observers as jobs
from sam_quantization_tpu.quant import quantizers as jqz
from sam_quantization_tpu.quant.fq import int_ops as jint
from sam_quantization_tpu.quant.fq import pipeline as jpipe
from sam_quantization_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, Linear
from sam_quantization_tpu_torch.quant import artifacts as tart
from sam_quantization_tpu_torch.quant import bit_type as tbt
from sam_quantization_tpu_torch.quant import observers as tobs
from sam_quantization_tpu_torch.quant import quantizers as tqz
from sam_quantization_tpu_torch.quant.fq import int_ops as tint
from sam_quantization_tpu_torch.quant.fq import pipeline as tpipe

JB, TB = jbt.BIT_TYPE_DICT, tbt.BIT_TYPE_DICT
# (method, channel_wise): percentile is layer-wise only, as in the reference
# (percentile.py:26); ptf is the channel-wise LN-input observer.
OBSERVERS = [("minmax", False), ("minmax", True), ("ema", False), ("ema", True),
             ("percentile", False), ("omse", False), ("omse", True), ("ptf", True)]

_jupdate = jax.jit(jobs.update, static_argnames=("method", "channel_wise"))
_jparams = jax.jit(jobs.get_quantization_params,
                   static_argnames=("method", "bt", "channel_wise", "symmetric"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def test_bit_types_match_jax():
    assert sorted(TB) == sorted(JB)
    for name, t in TB.items():
        j = JB[name]
        assert (t.bits, t.signed, t.name, t.upper_bound, t.lower_bound, t.range) == \
            (j.bits, j.signed, j.name, j.upper_bound, j.lower_bound, j.range)


# --------------------------------------------------------------- quantizers


@pytest.mark.parametrize("bt", ["uint8", "int8", "uint4", "int4"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_uniform_quantizers_match_jax(rng, bt, per_channel):
    """Random values, values exactly at the ties ``x / s + z = k + 1/2``
    (s a power of two), and values past both ends of the grid."""
    C = 48
    x = rng.normal(size=(16, C)).astype(np.float32) * 4
    if per_channel:
        scale = (rng.uniform(0.01, 0.1, C)).astype(np.float32)
        zero = rng.integers(0, 16, C).astype(np.float32)
    else:
        scale, zero = np.float32(0.03), np.float32(7)
    s, z = np.float32(2.0**-5), np.float32(3)
    ties = ((np.arange(-300, 300, dtype=np.float32) + 0.5) - z) * s  # exact in float32
    for xs, ss, zz in ((x, scale, zero), (ties, s, z)):
        jq = jqz.uniform_quant(jnp.asarray(xs), ss, zz, JB[bt])
        _equal(tqz.uniform_quant(_t(xs), _t(ss), _t(zz), TB[bt]), jq)
        _equal(tqz.uniform_fake_quant(_t(xs), _t(ss), _t(zz), TB[bt]),
               jqz.uniform_fake_quant(jnp.asarray(xs), ss, zz, JB[bt]))
        _equal(tqz.uniform_dequant(tqz.uniform_quant(_t(xs), _t(ss), _t(zz), TB[bt]), _t(ss),
                                   _t(zz)), jqz.uniform_dequant(jq, ss, zz))


def test_exp2_and_log2_take_xla_forms():
    """``jnp.exp2`` is ``exp(x * float32(ln 2))`` (inexact at integers) and
    ``jnp.log2`` is ``log(x) * float32(1 / ln 2)``: the port's table gives
    XLA's values at every integer of [-125, 127] but 32 (which only a
    flushed LIS ratio reaches), and its log2 at every power of two above
    its 1e-30 floor."""
    k = np.setdiff1d(np.arange(-125, 128), [32]).astype(np.float32)
    _equal(tqz._exp2(_t(k)), jnp.exp2(jnp.asarray(k)))
    assert not np.array_equal(np.asarray(jnp.exp2(jnp.asarray(k))), np.exp2(k))
    p = (2.0 ** np.arange(-99, 100)).astype(np.float32)  # above the 1e-30 floor
    _equal(tqz._log2(_t(p)), jnp.log2(jnp.asarray(p)))


def test_log2_quantizer_and_log_round_match_jax(rng):
    uint4 = "uint4"
    rand = rng.uniform(0, 1, 200_000).astype(np.float32)
    pow2 = (2.0 ** -np.arange(0, 40)).astype(np.float32)
    for xs in (rand, pow2, np.zeros(3, np.float32)):
        _equal(tqz.log2_fake_quant(_t(xs), TB[uint4]), jqz.log2_fake_quant(jnp.asarray(xs), JB[uint4]))
    centers = (2.0 ** -(np.arange(0, 20) + 0.5)).astype(np.float32).view(np.int32)
    near = np.concatenate([np.arange(c - 200, c + 201, dtype=np.int32) for c in centers]).view(np.float32)
    got = tqz.log2_fake_quant(_t(near), TB[uint4]).numpy()
    want = np.asarray(jqz.log2_fake_quant(jnp.asarray(near), JB[uint4]))
    flips = int((got != want).sum())
    assert flips <= near.size // 1000, (flips, near.size)
    assert np.all(np.isin(got, [0.0, *tqz._exp2(-torch.arange(16.0)).numpy()]))

    ratios = np.concatenate([rng.integers(1, 2**30, 50_000), 2 ** np.arange(31),
                             3 * 2 ** np.arange(29), 3 * 2 ** np.arange(29) - 1]).astype(np.float32)
    _equal(tqz.log_round(_t(ratios)), jqz.log_round(jnp.asarray(ratios)))


# ---------------------------------------------------------------- int ops


def test_get_mn_matches_jax(rng):
    a = np.concatenate([np.abs(rng.normal(size=5000)) * 10 + 1e-3,
                        2.0 ** np.arange(-20, 8)]).astype(np.float32)
    for got, want in zip(tint.get_mn(_t(a)), jint.get_mn(jnp.asarray(a))):
        _equal(got, want)


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("per_channel_out", [False, True])
def test_int_layer_norm_matches_jax(rng, expand, per_channel_out):
    C = 64
    x = rng.normal(size=(6, 10, C)).astype(np.float32) * 3
    in_scale = (np.float32(0.05) * 2.0 ** rng.integers(0, 4, C)).astype(np.float32)
    w = (rng.normal(size=C) * 0.2 + 1).astype(np.float32)
    b = (rng.normal(size=C) * 0.1).astype(np.float32)
    out_scale = (rng.uniform(0.02, 0.04, C) if per_channel_out else np.float32(0.03)).astype(np.float32)
    got = tint.int_layer_norm(_t(x), _t(w), _t(b), _t(in_scale), _t(out_scale), expand)
    want = jint.int_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), in_scale,
                               out_scale, expand)
    _equal(got, want)
    jitted = jax.jit(jint.int_layer_norm, static_argnums=5)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), in_scale, out_scale, expand)
    _equal(got, jitted)


@pytest.mark.parametrize("sf", [0.021, 0.05, 0.004])
def test_int_softmax_and_lis_match_jax(rng, sf):
    """i-exp numerators bit-equal, denominators rel 1e-6, LIS outputs with
    at most 1 in 10^4 values flipped (none measured)."""
    x = rng.normal(size=(4, 16, 96)).astype(np.float32) * 4
    x[0, 0] = 0.0  # a row of equal logits
    sf = np.float32(sf)
    e_t, s_t = tint.int_softmax_core(_t(x), _t(sf))
    e_j, s_j = jint.int_softmax_core(jnp.asarray(x), sf)
    _equal(e_t, e_j)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    got = tint.log_int_softmax(_t(x), _t(sf), TB["uint4"]).numpy()
    for want in (jint.log_int_softmax(jnp.asarray(x), sf, JB["uint4"]),
                 jax.jit(jint.log_int_softmax, static_argnums=2)(jnp.asarray(x), sf, JB["uint4"])):
        assert int((got != np.asarray(want)).sum()) <= got.size // 10_000


# -------------------------------------------------------------- observers


def _stream(xs, method, channel_wise, state_j=None):
    """The same batches through JAX's jitted update and the port's, from one
    (optionally mid-calibration) state carried across."""
    C = xs[0].shape[-1] if channel_wise else None
    sj = state_j if state_j is not None else jobs.init_state(C)
    st = tpipe.states_to({"p": sj}, "cpu")["p"]
    for x in xs:
        sj = _jupdate(sj, jnp.asarray(x), method, channel_wise)
        st = tobs.update(st, _t(x), method, channel_wise)
    return sj, st


@pytest.mark.parametrize("method,channel_wise", OBSERVERS)
def test_observer_update_matches_jax(rng, method, channel_wise):
    xs = [rng.normal(size=(3, 40, 32)).astype(np.float32) * (1 + i) for i in range(3)]
    sj, st = _stream(xs, method, channel_wise)
    # and on from a mid-calibration state, carried across
    sj, st = _stream(xs[:1], method, channel_wise, state_j=sj)
    _equal(st.min_val, sj.min_val)
    _equal(st.max_val, sj.max_val)
    assert bool(st.initialized) and bool(sj.initialized)


@pytest.mark.parametrize("bt", ["uint8", "int8", "uint4"])
@pytest.mark.parametrize("method,channel_wise", OBSERVERS)
def test_observer_params_match_jax(rng, method, channel_wise, bt):
    xs = [rng.normal(size=(2, 50, 24)).astype(np.float32) * (1 + i) for i in range(2)]
    xs[-1][0, 0, 3] = 40.0  # an outlier for omse / ptf to trade against
    sj, _ = _stream(xs, method, channel_wise)
    st = tpipe.states_to({"p": sj}, "cpu")["p"]
    scale_j, zero_j = _jparams(sj, method, JB[bt], channel_wise, inputs=jnp.asarray(xs[-1]))
    scale_t, zero_t = tobs.get_quantization_params(st, method, TB[bt], channel_wise,
                                                   inputs=_t(xs[-1]))
    assert scale_t.shape == scale_j.shape
    _equal(zero_t, zero_j)
    if method in ("omse", "ptf"):
        np.testing.assert_allclose(scale_t.numpy(), np.asarray(scale_j), rtol=1e-6, atol=0)
        if method == "ptf":
            _equal(scale_t / scale_t.min(), np.asarray(scale_j) / np.asarray(scale_j).min())
    else:
        _equal(scale_t, scale_j)


def test_percentile_past_2_24_elements():
    """``torch.quantile`` refuses more than 2^24 elements; the port's
    quantile takes JAX's float32 position and gives its values bit for bit."""
    x = np.random.default_rng(3).standard_normal(2**24 + 12345).astype(np.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(_t(x[: 2**24 + 1]), 0.5)
    sj = _jupdate(jobs.init_state(None), jnp.asarray(x), "percentile", False)
    st = tobs.update(tobs.init_state(None), _t(x), "percentile", False)
    _equal(st.max_val, sj.max_val)
    _equal(st.min_val, sj.min_val)


# ---------------------------------------------------------------- weights


def test_weight_params_and_fq_weights_match_jax(rng):
    """JAX's (K, N) linear, (kh, kw, I, O) conv and transposed-conv weights,
    quantized per output channel, against the port's ``Linear`` (N, K),
    ``Conv2d`` OIHW and ``ConvTranspose2d`` (I, O, k, k) holding the same
    weights; one output channel all zero."""
    cfg = jpipe.FQConfig()
    lin = rng.normal(size=(40, 24)).astype(np.float32)
    conv = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    convt = rng.normal(size=(2, 2, 16, 12)).astype(np.float32)
    lin[:, 5] = 0.0
    jtree = {"lin": {"w": lin, "b": np.ones(24, np.float32)}, "conv": {"w": conv},
             "convt": {"w": convt, "b": np.zeros(12, np.float32)},
             "ln": {"w": np.ones(7, np.float32), "b": np.zeros(7, np.float32)}}
    jq = jpipe.fq_quantize_weights(jax.tree_util.tree_map(jnp.asarray, jtree), cfg)

    mods = torch.nn.ModuleDict({"lin": Linear(40, 24), "conv": Conv2d(8, 16, 3, padding=1),
                                "convt": ConvTranspose2d(16, 12, 2)})
    with torch.no_grad():
        mods["lin"].weight.copy_(_t(lin.T))
        mods["lin"].bias.fill_(1.0)
        mods["convt"].bias.zero_()
        mods["conv"].weight.copy_(_t(conv.transpose(3, 2, 0, 1)))
        mods["convt"].weight.copy_(_t(convt.transpose(2, 3, 0, 1)))
    for name, w, axis, perm in (("lin", lin, 0, (1, 0)), ("conv", conv, 0, (3, 2, 0, 1)),
                                ("convt", convt, 1, (2, 3, 0, 1))):
        sj, zj = jobs.weight_params(jnp.asarray(w.reshape(-1, w.shape[-1])), JB["int8"])
        st, zt = tobs.weight_params(mods[name].weight, TB["int8"], channel_axis=axis)
        _equal(st, sj)
        _equal(zt, zj)
    tq = tpipe.fq_quantize_weights(mods, tpipe.FQConfig())
    assert torch.equal(mods["lin"].weight, _t(lin.T))  # a copy unless inplace
    for name, perm in (("lin", (1, 0)), ("conv", (3, 2, 0, 1)), ("convt", (2, 3, 0, 1))):
        _equal(tq[name].weight, np.asarray(jq[name]["w"]).transpose(perm))
    _equal(tq["lin"].bias, jq["lin"]["b"])


def test_fq_qparams_file_roundtrip(tmp_path):
    """``fq_qparams.npz`` with the JAX CLI's keys, both ways; the reader
    returns {} without the file, and ``qparams_to`` carries what it reads
    to tensors unchanged."""
    qp = {"blocks.0.qact2": (np.arange(1, 5, dtype=np.float32), np.zeros(4, np.float32)),
          "qact_embed": (np.float32(0.5), np.float32(3.0))}
    jnp_qp = {k: tuple(jnp.asarray(v) for v in sz) for k, sz in qp.items()}
    # the JAX CLI's writer (cli/quantize.py:145-151)
    np.savez(tmp_path / "fq_qparams.npz", **{f"{k}.{i}": np.asarray(v)
                                             for k, (s, z) in jnp_qp.items()
                                             for i, v in (("scale", s), ("zero", z))})
    got = tart.load_fq_qparams(str(tmp_path))
    assert sorted(got) == sorted(qp)
    for k in qp:
        for g, w in zip(got[k], qp[k]):
            _equal(g, w)
    (tmp_path / "b").mkdir()
    tart.save_fq_qparams(str(tmp_path / "b"), tpipe.qparams_to(got, "cpu"))
    with np.load(tmp_path / "b" / "fq_qparams.npz") as a, np.load(tmp_path / "fq_qparams.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            _equal(a[f], b[f])
    back = tpipe.qparams_to(got, "cpu")
    assert all(np.array_equal(back[k][i].numpy(), got[k][i]) for k in got for i in range(2))
    assert tart.load_fq_qparams(str(tmp_path / "none")) == {}
