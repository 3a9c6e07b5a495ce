"""Port parity: the stage probes' kernels (P1-P5 of PERF.md's kernel table)
and the two flash-attention repairs their drivers need, on the CPU.

P1-P3 are the real ``tools/packed_probe.py`` kernel functions, imported by
path and run under ``pl.pallas_call(..., interpret=True)``. P4 and P5 are
nested in ``tools/global_stage_probe.py``'s ``main`` and cannot be imported:
their bodies are transcribed below, with the lines they come from. Inputs are
drawn with numpy from a seed and handed to both packages.

Tolerances, bfloat16: both sides multiply the same bf16 values and sum in
float32 in another order, so a rounding of p (or s) to bf16, or of an
output, may flip by one step: |d| <= 2**-7 |ref| + C max|ref| with
C = 2**-10. Float32 (the JAX kernels take it too): |d| <= 1e-5 max|ref|.
"""

import functools
import importlib.util
import io
import pathlib
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sam_quantization_tpu.ops import flash_attention as jfa
from sam_quantization_tpu_torch.ops import flash_attention as tfa
from sam_quantization_tpu_torch.ops import probes
from sam_quantization_tpu_torch.tools import global_stage_probe, packed_probe

REPO = pathlib.Path(__file__).resolve().parents[1]
C_BF16 = 2.0**-10
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _load_tpu_probe():
    """tools/packed_probe.py as a module; its import sets JAX's compilation
    cache settings, which are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location("tpu_packed_probe", REPO / "tools" / "packed_probe.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


TPU_PROBE = _load_tpu_probe()


def _close(out, ref, dtype):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    peak = np.abs(ref).max()
    bound = (2.0**-7 * np.abs(ref) + C_BF16 * peak) if dtype == "bf16" else 1e-5 * peak
    d = np.abs(out - ref)
    assert (d <= bound).all(), (d.max(), float(((d - bound) / peak).max()))


def _pair(seed, BH, L, hd, dtype, D=128):
    """q prescaled by hd**-0.5 * log2(e), k and v; all padded to D lanes, as
    the global-stage probe builds them."""
    r = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    q, k, v = (r.standard_normal((BH, L, hd)).astype(np.float32) for _ in range(3))
    q = np.asarray(jnp.asarray(q, jdt) * (hd**-0.5 * jfa.LOG2E), np.float32)
    q, k, v = (np.pad(a, ((0, 0), (0, 0), (0, D - hd))) for a in (q, k, v))
    return [jnp.asarray(a, jdt) for a in (q, k, v)], [torch.from_numpy(a).to(tdt) for a in (q, k, v)]


# ---------------------------------------------------------------------------
# P1-P3: tools/packed_probe.py's kernels
# ---------------------------------------------------------------------------

NW, NH, HD, WS = 2, 2, 16, 4  # L = 16 rows, padded to Lp = 128 for the TPU kernels
L, LP = WS * WS, 128


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_no_softmax_plain_matches_tpu_kernel(dtype):
    """P1 on inputs zero-padded to Lp rows (the TPU kernel reads Lp rows; on
    zero rows its answer for the L real rows is the L-row answer)."""
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(0)
    CH, R = NH * HD, 2 * WS
    q, k, v = (r.standard_normal((NW, L, CH)).astype(np.float32) for _ in range(3))
    rel = (r.standard_normal((NW, NH, L, R)) * 0.3).astype(np.float32)
    padded = [np.pad(a, ((0, 0), (0, LP - L), (0, 0))) for a in (q, k, v)]
    padded.append(np.pad(rel, ((0, 0), (0, 0), (0, LP - L), (0, 0))))
    rows = pl.BlockSpec((1, LP, CH), lambda i: (i, 0, 0))
    ref = pl.pallas_call(
        functools.partial(TPU_PROBE._kernel_no_softmax, nh=NH, hd=HD, scale=HD**-0.5),
        grid=(NW,), in_specs=[rows, rows, rows, pl.BlockSpec((1, NH, LP, R), lambda i: (i, 0, 0, 0))],
        out_specs=rows, out_shape=jax.ShapeDtypeStruct((NW, LP, CH), jdt), interpret=True,
    )(*(jnp.asarray(a, jdt) for a in padded))
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, rel)]
    out = probes.probe_no_softmax(*t, HD**-0.5, nh=NH, hd=HD)
    assert out.dtype == tdt and tuple(out.shape) == (NW, L, CH)
    _close(out, np.asarray(ref, np.float32)[:, :L], dtype)
    # heads read in place from the packed qkv layout give the same answer
    qkv = torch.cat(t[:3], -1)
    sliced = probes.probe_no_softmax(qkv[..., :CH], qkv[..., CH:2 * CH], qkv[..., 2 * CH:], t[3],
                                     HD**-0.5, nh=NH, hd=HD)
    assert torch.equal(sliced, out)


# P1's operands as csrc/probe_packed.cu's TMA copies take them
# (probes.aug_operands): heads read in place from the packed qkv where hd, the
# strides and the starts allow it (hd 16, 80); else copied with each head
# zero-padded to a multiple of 8 (hd 20; hd 16 starting 2 bytes past a
# 16-byte boundary); rel padded to R' = round_up(R, 8) (R 28, 14, 100; 32
# needs none). The plain version on what it gives, cut to hd, is the plain
# version on the operands as they were.
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd,R,offset,in_place", [(16, 28, 0, True), (80, 14, 0, True),
                                                  (20, 100, 0, False), (16, 32, 1, False)])
def test_aug_operands_keep_the_function(dtype, hd, R, offset, in_place):
    _, tdt = DTYPES[dtype]
    r = np.random.default_rng(3)
    CH = NH * hd
    flat = torch.from_numpy(r.standard_normal(NW * L * 3 * CH + offset).astype(np.float32)).to(tdt)
    qkv = flat[offset:].view(NW, L, 3 * CH)
    q, k, v = qkv[..., :CH], qkv[..., CH:2 * CH], qkv[..., 2 * CH:]
    rel = torch.from_numpy((r.standard_normal((NW, NH, L, R)) * 0.3).astype(np.float32)).to(tdt)
    qa, ka, va, rela, hdk = probes.aug_operands(q, k, v, rel, nh=NH, hd=hd)
    if tdt == torch.bfloat16:  # the layout the kernel's TMA copies take
        assert hdk % 8 == 0 and qa.stride(0) % 8 == 0 and qa.stride(1) % 8 == 0
        assert all(t.data_ptr() % 16 == 0 for t in (qa, ka, va, rela))
        assert rela.shape[-1] == R + -R % 8 and not rela[..., R:].any()
        assert (qa.data_ptr() == q.data_ptr()) == in_place
    assert torch.equal(rela[..., :R], rel) and ka.stride() == qa.stride() == va.stride()
    assert torch.equal(qa.reshape(NW, L, NH, hdk)[..., :hd], q.reshape(NW, L, NH, hd))
    assert hdk == hd or not qa.reshape(NW, L, NH, hdk)[..., hd:].any()
    out = probes.probe_no_softmax_plain(qa, ka, va, rela, hd**-0.5, nh=NH, hd=hdk)
    out = out.reshape(NW, L, NH, hdk)[..., :hd].reshape(NW, L, CH)
    ref = probes.probe_no_softmax_plain(q, k, v, rel, hd**-0.5, nh=NH, hd=hd)
    _close(out, ref.float().numpy(), dtype)


def _presplit_operands(seed, dtype, rows=L, d=HD, padded=True):
    """Heads of ``rows`` rows and ``d`` columns, split and, as the probe's
    ``presplit_prep`` lays them out, zero-padded to (NW, nh, Lp, 128)."""
    r = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    pad = ((0, 0), (0, 0), (0, LP - rows), (0, 128 - d)) if padded else ((0, 0),) * 4
    ops = [np.pad(r.standard_normal((NW, NH, rows, d)).astype(np.float32) * 0.5, pad)
           for _ in range(3)]
    return [jnp.asarray(a, jdt) for a in ops], [torch.from_numpy(a).to(tdt) for a in ops]


def _call_heads(kernel, ops, jdt):
    shape = tuple(ops[0].shape)
    spec = pl.BlockSpec((1, *shape[1:]), lambda i: (i, 0, 0, 0))
    return pl.pallas_call(kernel, grid=(shape[0],), in_specs=[spec] * 3, out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(shape, jdt), interpret=True)(*ops)


# P2 as the probe lays its heads out (L 16 padded to (128, 128)), and at the
# card tests' ragged shapes, unpadded: L 200 with D 80 (a ragged last key
# tile), L 70 with D 20 (rows the kernel's TMA copies take padded to 24).
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,padded", [(L, HD, True), (200, 80, False), (70, 20, False)],
                         ids=["probe-layout", "L200-D80", "L70-D20"])
def test_dots_floor_plain_matches_tpu_kernel(dtype, rows, d, padded):
    jops, tops = _presplit_operands(1, dtype, rows, d, padded)
    ref = _call_heads(TPU_PROBE._kernel_dots_floor, jops, DTYPES[dtype][0])
    out = probes.probe_dots_floor(*tops)
    assert out.dtype == DTYPES[dtype][1] and out.shape == tops[0].shape
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("exp2", [True, False])
def test_presplit_plain_matches_tpu_kernel(dtype, exp2):
    """The padded keys (s = 0) take part in the softmax on both sides."""
    jops, tops = _presplit_operands(2, dtype)
    ref = _call_heads(functools.partial(TPU_PROBE._kernel_presplit, exp2=exp2), jops,
                      DTYPES[dtype][0])
    out = probes.probe_presplit(*tops, exp2=exp2)
    _close(out, ref, dtype)
    with_pad_keys = probes.probe_presplit(*(t[:, :, :L] for t in tops), exp2=exp2)
    assert not torch.allclose(with_pad_keys.float(), out[:, :, :L].float(), atol=1e-3)


# ---------------------------------------------------------------------------
# P4-P5: tools/global_stage_probe.py's nested kernels, transcribed
# ---------------------------------------------------------------------------


def _k_pair(q_ref, k_ref, v_ref, o_ref, *, halves, clamp):
    """tools/global_stage_probe.py:183-207, the body unchanged."""
    BQ = q_ref.shape[1]
    h = BQ // halves
    outs = []
    for i in range(halves):
        s = jax.lax.dot_general(
            q_ref[0, i * h : (i + 1) * h], k_ref[0],
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        if clamp:
            p = jnp.exp2(jnp.minimum(s, 40.0) - 40.0)
        else:
            m = jnp.max(s, axis=-1, keepdims=True)
            p = jnp.exp2(s - m)
        r = 1.0 / jnp.sum(p, axis=-1, keepdims=True)
        o = jnp.dot(p.astype(v_ref.dtype), v_ref[0],
                    preferred_element_type=jnp.float32)
        outs.append((o * r).astype(o_ref.dtype))
    for i in range(halves):
        o_ref[0, i * h : (i + 1) * h] = outs[i]


def _k_pair_bias(q_ref, k_ref, v_ref, rh_ref, rw_ref, o_ref, *,
                 halves, clamp, kh, kw):
    """tools/global_stage_probe.py:316-352, the body unchanged."""
    BQ = q_ref.shape[1]
    hh = BQ // halves
    outs = []
    per = 128 // kw
    for i in range(halves):
        s = jax.lax.dot_general(
            q_ref[0, i * hh : (i + 1) * hh], k_ref[0],
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        Lk = s.shape[1]
        rhh = rh_ref[0, i * hh : (i + 1) * hh].astype(jnp.float32)
        rww = rw_ref[0, i * hh : (i + 1) * hh].astype(jnp.float32)
        rw128 = jnp.concatenate([rww[:, :kw]] * per, axis=-1)
        hsel = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1) // kw
        pieces = []
        for j in range(Lk // 128):
            bias = rw128
            for t in range(per):
                bias = bias + jnp.where(
                    hsel == t, rhh[:, j * per + t][:, None], 0.0
                )
            pieces.append(s[:, j * 128 : (j + 1) * 128] + bias)
        s = jnp.concatenate(pieces, axis=-1)
        if clamp:
            p = jnp.exp2(jnp.minimum(s, 40.0) - 40.0)
        else:
            m = jnp.max(s, axis=-1, keepdims=True)
            p = jnp.exp2(s - m)
        r = 1.0 / jnp.sum(p, axis=-1, keepdims=True)
        o = jnp.dot(p.astype(v_ref.dtype), v_ref[0],
                    preferred_element_type=jnp.float32)
        outs.append((o * r).astype(o_ref.dtype))
    for i in range(halves):
        o_ref[0, i * hh : (i + 1) * hh] = outs[i]


PAIR_BH, PAIR_L, PAIR_HD, BLOCK_Q = 2, 256, 16, 128


def _pair_call(kernel, ops, jdt, extra_specs=()):
    """The probe's ``make_pair`` / ``make_pair_bias`` launch, in interpret mode."""
    rows = pl.BlockSpec((1, BLOCK_Q, 128), lambda b, i: (b, i, 0))
    whole = pl.BlockSpec((1, PAIR_L, 128), lambda b, i: (b, 0, 0))
    return pl.pallas_call(
        kernel, grid=(PAIR_BH, PAIR_L // BLOCK_Q),
        in_specs=[rows, whole, whole, *extra_specs], out_specs=rows,
        out_shape=jax.ShapeDtypeStruct((PAIR_BH, PAIR_L, 128), jdt), interpret=True,
    )(*ops)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("halves", [1, 2])
def test_pair_plain_matches_tpu_kernel(dtype, clamp, halves):
    jops, tops = _pair(3, PAIR_BH, PAIR_L, PAIR_HD, dtype)
    ref = _pair_call(functools.partial(_k_pair, halves=halves, clamp=clamp), jops,
                     DTYPES[dtype][0])
    _close(probes.probe_pair(*tops, clamp=clamp), ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("halves", [1, 2])
def test_pair_bias_plain_matches_tpu_kernel(dtype, clamp, halves):
    """L = 256 on a 16 x 16 grid (the TPU kernel needs L % 128 == 0 and
    128 % kw == 0); raw rel tiles with the probe's 0.05 scale, here 2.0 so
    that the bias moves the softmax."""
    kh = kw = 16
    jdt, tdt = DTYPES[dtype]
    jops, tops = _pair(4, PAIR_BH, PAIR_L, PAIR_HD, dtype)
    r = np.random.default_rng(5)
    rh, rw = ((r.standard_normal((PAIR_BH, PAIR_L, n)) * 2.0).astype(np.float32) for n in (kh, kw))
    tile = lambda n: pl.BlockSpec((1, BLOCK_Q, n), lambda b, i: (b, i, 0))  # noqa: E731
    ref = _pair_call(functools.partial(_k_pair_bias, halves=halves, clamp=clamp, kh=kh, kw=kw),
                     [*jops, jnp.asarray(rh, jdt), jnp.asarray(rw, jdt)], jdt,
                     (tile(kh), tile(kw)))
    t_rh, t_rw = torch.from_numpy(rh).to(tdt), torch.from_numpy(rw).to(tdt)
    out = probes.probe_pair_bias(*tops, t_rh, t_rw, clamp=clamp)
    _close(out, ref, dtype)
    assert not torch.allclose(out.float(), probes.probe_pair(*tops, clamp=clamp).float(), atol=1e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("kw", [8, 32, 128])
def test_pair_bias_plain_matches_tpu_kernel_at_other_grids(dtype, clamp, kw):
    """P5 at the other kw that divide 128 (L 256 on 32 x 8, 8 x 32 and 2 x
    128 grids; the card kernel reads its index table at each, and holds its
    rw columns in registers only at kw 64)."""
    kh = PAIR_L // kw
    jdt, tdt = DTYPES[dtype]
    jops, tops = _pair(14, PAIR_BH, PAIR_L, PAIR_HD, dtype)
    r = np.random.default_rng(15)
    rh, rw = ((r.standard_normal((PAIR_BH, PAIR_L, n)) * 2.0).astype(np.float32) for n in (kh, kw))
    tile = lambda n: pl.BlockSpec((1, BLOCK_Q, n), lambda b, i: (b, i, 0))  # noqa: E731
    ref = _pair_call(functools.partial(_k_pair_bias, halves=1, clamp=clamp, kh=kh, kw=kw),
                     [*jops, jnp.asarray(rh, jdt), jnp.asarray(rw, jdt)], jdt,
                     (tile(kh), tile(kw)))
    t_rh, t_rw = torch.from_numpy(rh).to(tdt), torch.from_numpy(rw).to(tdt)
    _close(probes.probe_pair_bias(*tops, t_rh, t_rw, clamp=clamp), ref, dtype)


def test_pair_clamp_has_no_floor():
    """P4's static shift has no floor: a row whose logits all lie far below
    40 sums to 0 and gives NaN, on both sides."""
    jops, tops = _pair(6, 1, PAIR_L, PAIR_HD, "f32")
    jops[0], tops[0] = jops[0] * 0 - 1.0, tops[0] * 0 - 1.0  # s = -sum(k), far below 40
    jops[1], tops[1] = jops[1] * 0 + 20.0, tops[1] * 0 + 20.0
    ref = np.asarray(_pair_call(functools.partial(_k_pair, halves=1, clamp=True), jops,
                                jnp.float32))
    out = probes.probe_pair(*tops, clamp=True)
    assert np.isnan(ref).all() and torch.isnan(out).all()
    assert torch.isfinite(probes.probe_pair(*tops, clamp=False)).all()


def _both(arrays, dtype):
    """The same numpy arrays as JAX and torch operands of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)).to(tdt) for a in arrays])


def _edge_rows(arrays, edge):
    """Row-max edge rows on numpy copies of q, k, v (BH, L, D), through the
    last lane (zero padding in the probes' layouts): ``dominant``, row 5 of
    head 0 with one logit 256 above the rest (every other p underflows to 0,
    the row is that key's v); ``tied``, row 5 with s = 6 on every fifth key
    and 0 elsewhere; ``padded``, the last quarter of the keys zero (s = 0:
    they take part in the max, the sum and p.v)."""
    q, k, v = (np.array(a, np.float32) for a in arrays)
    L = q.shape[1]
    if edge == "padded":
        k[:, L - L // 4:], v[:, L - L // 4:] = 0, 0
    else:
        q[0, 5] = 0
        q[0, 5, -1] = 64.0 if edge == "dominant" else 2.0
        k[..., -1] = 0
        if edge == "dominant":
            k[0, 7, -1] = 4.0
        else:
            k[0, ::5, -1] = 3.0
    return q, k, v


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["presplit exp2", "presplit exp", "pair"])
@pytest.mark.parametrize("edge", ["dominant", "tied", "padded"])
def test_rowmax_edge_rows_match_tpu_kernel(dtype, kernel, edge):
    """P3 (exp2 and exp) and P4's row-max mode on the edge rows of
    ``_edge_rows``, the plain version against the TPU kernel; the card tests
    hold the kernel to the same rows."""
    jdt = DTYPES[dtype][0]
    if kernel == "pair":
        jops, _ = _pair(9, PAIR_BH, PAIR_L, PAIR_HD, dtype)
    else:
        jops, _ = _presplit_operands(10, dtype)
        jops = [a.reshape(NW * NH, LP, 128) for a in jops]
    jops, tops = _both(_edge_rows([np.asarray(a, np.float32) for a in jops], edge), dtype)
    if kernel == "pair":
        ref = _pair_call(functools.partial(_k_pair, halves=1, clamp=False), jops, jdt)
        out = probes.probe_pair(*tops, clamp=False)
    else:
        exp2 = kernel == "presplit exp2"
        ref = _call_heads(functools.partial(TPU_PROBE._kernel_presplit, exp2=exp2),
                          [a.reshape(NW, NH, LP, 128) for a in jops], jdt).reshape(NW * NH, LP, 128)
        out = probes.probe_presplit(*tops, exp2=exp2)
    _close(out, ref, dtype)
    if edge == "dominant":
        np.testing.assert_array_equal(np.asarray(ref, np.float32)[0, 5],
                                      np.asarray(jops[2], np.float32)[0, 7])
        assert torch.equal(out[0, 5], tops[2][0, 7])
    if edge == "tied":
        p = np.where(np.arange(out.shape[1]) % 5 == 0, 1.0, 2.0**-6 if kernel != "presplit exp"
                     else float(np.exp(np.float32(-6))))
        assert abs(float(out[0, 5, 0]) - float((p @ tops[2][0, :, 0].double().numpy()) / p.sum())) \
            <= 2.0**-7 * abs(float(out[0, 5, 0])) + 1e-3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pair_clamp_subnormal_band(dtype):
    """Clamp-40 logits in (-109, -86) give p = 2^(s - 40) below 2^-126. Row 5
    of head 0 mixes such keys (s = -44 k, k = 2 + (n % 8) / 16 on the last
    lane: s in [-107.25, -88]) with keys at s = 40: finite, and equal to the
    TPU kernel, whose p for the band keys JAX flushes to zero on the CPU
    (XLA, as TPUs, flushes subnormals). Row 7 has only band keys: PyTorch
    keeps the subnormal p (IEEE gradual underflow), so its sum p is finite
    and the row is the mean of v weighted by round(p); JAX flushes every p to
    0 and gives NaN. The card kernel follows the plain version (the card
    test of the same row), so this row is where the port and the reference
    part: a known difference (ROADMAP Queue 3)."""
    jops, _ = _pair(11, PAIR_BH, PAIR_L, PAIR_HD, dtype)
    q, k, v = (np.array(a, np.float32) for a in jops)
    k[..., -1] = 2 + (np.arange(PAIR_L) % 8) / 16
    k[0, ::16, -2] = 1.0
    q[0, 5] = 0
    q[0, 5, -1], q[0, 5, -2] = -44.0, 128.0  # band keys, and every 16th key at s = 40
    q[0, 7] = 0
    q[0, 7, -1] = -44.0
    jops, tops = _both((q, k, v), dtype)
    ref = np.asarray(_pair_call(functools.partial(_k_pair, halves=1, clamp=True), jops,
                                DTYPES[dtype][0]), np.float32)
    out = probes.probe_pair(*tops, clamp=True)
    assert np.isfinite(ref[0, 5]).all() and torch.isfinite(out[0, 5]).all()
    assert torch.isfinite(out[0, 7]).all() and float(out[0, 7].abs().max()) > 0
    assert np.isnan(ref[0, 7]).all()
    out, ref = out.clone(), ref.copy()
    out[0, 7], ref[0, 7] = 0, 0
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pair_bias_clamp_subnormal_band(dtype):
    """test_pair_clamp_subnormal_band's rows through P5, with a bias of -0.5
    on rows 5 and 7 of head 0 (rw -1, rh 0.5; random tiles elsewhere): row
    5's band keys take s = -44 k - 0.5 in [-107.75, -88.5] beside keys at
    s = 39.5, finite and equal to the TPU kernel; row 7 has only band keys,
    finite here (IEEE gradual underflow) and NaN in JAX, which flushes every
    p to 0. The same known difference as P4's (ROADMAP Queue 3); the card
    test of the same rows holds the kernel to the plain version."""
    kh = kw = 16
    jdt = DTYPES[dtype][0]
    jops, _ = _pair(12, PAIR_BH, PAIR_L, PAIR_HD, dtype)
    q, k, v = (np.array(a, np.float32) for a in jops)
    k[..., -1] = 2 + (np.arange(PAIR_L) % 8) / 16
    k[0, ::16, -2] = 1.0
    q[0, 5] = 0
    q[0, 5, -1], q[0, 5, -2] = -44.0, 128.0
    q[0, 7] = 0
    q[0, 7, -1] = -44.0
    r = np.random.default_rng(13)
    rh, rw = ((r.standard_normal((PAIR_BH, PAIR_L, n)) * 2.0).astype(np.float32) for n in (kh, kw))
    rh[0, [5, 7]], rw[0, [5, 7]] = 0.5, -1.0
    jops, tops = _both((q, k, v, rh, rw), dtype)
    tile = lambda n: pl.BlockSpec((1, BLOCK_Q, n), lambda b, i: (b, i, 0))  # noqa: E731
    ref = np.asarray(_pair_call(functools.partial(_k_pair_bias, halves=1, clamp=True, kh=kh,
                                                  kw=kw), jops, jdt, (tile(kh), tile(kw))),
                     np.float32)
    out = probes.probe_pair_bias(*tops, clamp=True)
    assert np.isfinite(ref[0, 5]).all() and torch.isfinite(out[0, 5]).all()
    assert torch.isfinite(out[0, 7]).all() and float(out[0, 7].abs().max()) > 0
    assert np.isnan(ref[0, 7]).all()
    out, ref = out.clone(), ref.copy()
    out[0, 7], ref[0, 7] = 0, 0
    _close(out, ref, dtype)


# ---------------------------------------------------------------------------
# The repairs: rel=None and bias3d=False, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qkv_packed_without_rel_matches_jax(dtype):
    """``rel=None`` is zero rel tiles through the same kernel, as in JAX;
    float32 atol 1e-4, bf16 atol 2e-2 (test_torch_flash_attention.py's)."""
    jdt, tdt = DTYPES[dtype]
    nw, nh, ws, hd = 2, 2, 14, 80
    r = np.random.default_rng(7)
    qkv = (r.standard_normal((nw, ws * ws, 3 * nh * hd)) * 0.5).astype(np.float32)
    kw = dict(nh=nh, hd=hd, kh=ws, kw=ws)
    ref = jfa.flash_attention_qkv_packed(jnp.asarray(qkv, jdt), None, hd**-0.5, interpret=True, **kw)
    t = torch.from_numpy(qkv).to(tdt)
    out = tfa.flash_attention_qkv_packed(t, None, hd**-0.5, **kw)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-4 if dtype == "f32" else 2e-2, rtol=0)
    zeros = torch.zeros((nw, nh, ws * ws, 2 * ws), dtype=tdt)
    assert torch.equal(out, tfa.flash_attention_qkv_packed(t, zeros, hd**-0.5, **kw))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bias3d_false_takes_the_head_split_kernel_like_jax(dtype):
    """A global-shape problem (L 1024 on 32 x 32) goes to the bias3d kernel by
    default and, with ``bias3d=False``, to the head-split kernel with its rel
    tiles (JAX's augmented kernel), which ignores ``out_inv_scale``. Against
    JAX's ``bias3d=False`` in interpret mode: float32 atol 1e-4, bf16 2e-2."""
    jdt, tdt = DTYPES[dtype]
    B, nh, G, hd = 1, 1, 32, 64
    r = np.random.default_rng(8)
    q, k = ((r.standard_normal((B, nh, G * G, hd)) * 0.5).astype(np.float32) for _ in range(2))
    v = r.standard_normal((B, nh, G * G, hd)).astype(np.float32)
    rh, rw = ((r.standard_normal((B, nh, G * G, G)) * 0.3).astype(np.float32) for _ in range(2))
    args = (q, k, v, rh, rw)
    assert tfa.route(G * G, (G, G)) == "flash_global"
    assert tfa.route(G * G, (G, G), bias3d=False) == "flash_rowblock"
    ref = jfa.flash_attention_relpos(*(jnp.asarray(a, jdt) for a in args), 0.125,
                                     interpret=True, bias3d=False)
    t = [torch.from_numpy(a).to(tdt) for a in args]
    out = tfa.flash_attention_relpos(*t, 0.125, bias3d=False, out_inv_scale=10.0)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-4 if dtype == "f32" else 2e-2, rtol=0)
    assert torch.equal(out, tfa.flash_attention_plain(*t, 0.125))


# ---------------------------------------------------------------------------
# The drivers, end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver,rows", [(packed_probe, 7), (global_stage_probe, 16)])
def test_probe_driver_runs_on_cpu(driver, rows):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = driver.main(["--platform", "cpu", "--model", "vit_tiny", "--iters", "1"])
    timed = [ln for ln in buf.getvalue().splitlines() if " ms" in ln]
    assert rc == 0 and len(timed) == rows, buf.getvalue()
    assert "cpu (host clock)" in buf.getvalue()
