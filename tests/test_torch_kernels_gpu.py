"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device, and skips itself where there is none. It imports no
JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

Attention tolerances: float32 atol 1e-4; bfloat16 one bf16 step of the
output, |d| <= 2**-7 |ref| + HS_BF16_C max|ref| (every attention kernel and
the stage probes' kernels; the plain version with its last key tile left
out of p.v must fail it); int8 epilogue |d| <= 1 on at most 0.5% of the
elements. The packed-weight and W-A8 kernels'
tolerances are stated above their tests; int8_matmul on the card equals the
CPU bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.ops import flash_attention as tfa
from sam_quantization_tpu_torch.ops import fused_mlp as tfm
from sam_quantization_tpu_torch.ops import probes as tpr
from sam_quantization_tpu_torch.ops import quant_matmul as tqm

DTYPES = {"f32": (torch.float32,), "bf16": (torch.bfloat16,)}
HS_BF16_C = 2.0**-10  # chip_smoke.py's, which says how it was set


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(seed, *shape):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32))


def _check(out, ref, dtype, quant):
    """int8 out: |d| <= 1 on at most 0.5% of the values; float32: atol 1e-4."""
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    if quant:
        d = np.abs(out - ref)
        assert d.max() <= 1.0 and (d > 0).mean() <= 0.005, (d.max(), (d > 0).mean())
    else:
        assert dtype == "f32", "bfloat16 attention is held to _check_hs"
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0.0)


def _check_hs(out, ref):
    """bf16 head-split rule: |d| <= 2**-7 |ref| + HS_BF16_C max|ref|."""
    d, r = (out.float() - ref.float()).abs(), ref.float().abs()
    reading = float(((d - 2.0**-7 * r) / r.max()).max())
    assert reading <= HS_BF16_C, (reading, float(d.max()))


def _hs_fails(wrong, ref):
    """The negative control: a wrong output must break the head-split rule."""
    with pytest.raises(AssertionError):
        _check_hs(wrong, ref)


def _check_attn(out, ref, dtype, quant):
    """float32 atol 1e-4; bfloat16 the head-split rule; int8 out <= 1 step
    on at most 0.5% of the values."""
    if dtype == "bf16" and not quant:
        assert out.dtype == torch.bfloat16
        _check_hs(out, ref)
    else:
        _check(out, ref, dtype, quant)


# The tensor-core body's edges (csrc/flash_tc.cuh): L 196 = 3 * 64 + 4 and
# L 25 leave most of the last key tile absent; hd 16 is one depth step, hd
# 24 pads to 32 in shared memory, hd 20 also takes the element-wise copy
# (rows not 16-byte multiples); hd 64 is ViT-B's and ViT-L's, and hd 128
# takes the one-block-an-SM build (tc::min_blocks).
WINDOWED_CASES = [(4, 80, 14), (4, 16, 5), (2, 24, 14), (2, 80, 5), (2, 16, 14), (2, 20, 5),
                  (2, 64, 14), (2, 128, 14), (1, 128, 5)]
GLOBAL_CASES = [(4, 80, 32), (4, 16, 32), (2, 24, 32), (2, 80, 64), (2, 24, 64), (1, 16, 64),
                (1, 20, 32), (2, 64, 32), (1, 64, 64), (2, 128, 32), (1, 128, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nh,hd,ws", WINDOWED_CASES)
def test_windowed_kernel_matches_plain(cuda, dtype, quant, nh, hd, ws):
    tdt = DTYPES[dtype][0]
    NW, L = 5, ws * ws
    qkv = _randn(0, NW, L, 3 * nh * hd).to(cuda, tdt)
    rel = _randn(1, NW, nh, L, 2 * ws).to(cuda, tdt)
    kw = dict(nh=nh, hd=hd, kh=ws, kw=ws)
    ois = None
    if quant:
        ois = 127.0 / float(tfa.flash_windowed_plain(qkv, rel, hd**-0.5, **kw).abs().max())
    before = tfa.LAUNCHES["flash_windowed"]
    out = tfa.flash_attention_qkv_packed(qkv, rel, hd**-0.5, out_inv_scale=ois, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_windowed"] == before + 1
    ref = tfa.flash_windowed_plain(qkv, rel, hd**-0.5, out_inv_scale=ois, **kw)
    _check_attn(out, ref, dtype, quant)
    if dtype == "bf16" and not quant:  # the last key tile left out of p.v
        skip = qkv.clone()
        skip[:, L - (L % 64 or 64):, 2 * nh * hd:] = 0
        _hs_fails(tfa.flash_windowed_plain(skip, rel, hd**-0.5, **kw), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nh,hd,g", GLOBAL_CASES)
def test_global_kernel_matches_plain(cuda, dtype, quant, nh, hd, g):
    tdt = DTYPES[dtype][0]
    L = g * g
    q, k, v = (_randn(s, 1, nh, L, hd).to(cuda, tdt) for s in (2, 3, 4))
    rh, rw = (_randn(s, 1, nh, L, g).to(cuda, tdt) for s in (5, 6))
    ois = None
    if quant:
        ois = 127.0 / float(tfa.flash_attention_plain(q, k, v, rh, rw, hd**-0.5).abs().max())
    before = tfa.LAUNCHES["flash_global"]
    out = tfa.flash_attention_relpos(q, k, v, rh, rw, hd**-0.5, out_inv_scale=ois)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_global"] == before + 1
    ref = tfa.flash_attention_plain(q, k, v, rh, rw, hd**-0.5, out_inv_scale=ois)
    _check_attn(out, ref, dtype, quant)
    if dtype == "bf16" and not quant:
        skip = v.clone()
        skip[..., L - 64:, :] = 0
        _hs_fails(tfa.flash_attention_plain(q, k, skip, rh, rw, hd**-0.5), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_windowed", "flash_global"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hd", [80, 24])
def test_all_below_floor_rows_on_card(cuda, kernel, quant, hd):
    """Every logit far below the clamp floor (rel tiles of -50, times log2 e
    -72 each): every real key gets p = 2^-124 and each row averages the L
    real keys, as the plain version does; absent keys add nothing. |v| <
    1/4, so 2^-124 v is subnormal: the kernels carry p times 2^64, which
    keeps the tensor cores' products normal."""
    bf = torch.bfloat16
    if kernel == "flash_windowed":
        nh, ws = 2, 14
        L = ws * ws
        qkv = _randn(20, 3, L, 3 * nh * hd)
        qkv[..., 2 * nh * hd:] = qkv[..., 2 * nh * hd:].clamp(-1, 1) * 0.2
        qkv = qkv.to(cuda, bf)
        rel = torch.full((3, nh, L, 2 * ws), -50.0, device=cuda, dtype=bf)
        kw = dict(nh=nh, hd=hd, kh=ws, kw=ws)
        fn = lambda ois=None: tfa.flash_attention_qkv_packed(  # noqa: E731
            qkv, rel, hd**-0.5, out_inv_scale=ois, **kw)
        plain = lambda ois=None: tfa.flash_windowed_plain(  # noqa: E731
            qkv, rel, hd**-0.5, out_inv_scale=ois, **kw)
        vals = qkv[..., 2 * nh * hd:].reshape(3, L, nh, hd).transpose(1, 2)
    else:
        nh, g = 2, 32
        L = g * g
        q, k = (_randn(s, 1, nh, L, hd).to(cuda, bf) for s in (21, 22))
        v = (_randn(23, 1, nh, L, hd).clamp(-1, 1) * 0.2).to(cuda, bf)
        rh, rw = (torch.full((1, nh, L, g), -50.0, device=cuda, dtype=bf) for _ in range(2))
        fn = lambda ois=None: tfa.flash_attention_relpos(  # noqa: E731
            q, k, v, rh, rw, hd**-0.5, out_inv_scale=ois)
        plain = lambda ois=None: tfa.flash_attention_plain(  # noqa: E731
            q, k, v, rh, rw, hd**-0.5, out_inv_scale=ois)
        vals = v
    mean = vals.float().mean(dim=-2, keepdim=True)  # (..., 1, hd): every row's answer
    ref = plain()
    if kernel == "flash_windowed":
        ref_rows = ref.float().reshape(3, L, nh, hd).transpose(1, 2)
    else:
        ref_rows = ref.float()
    assert float((ref_rows - mean).abs().max()) <= 2.0**-8 * float(mean.abs().max())
    ois = 127.0 / float(ref.float().abs().max()) if quant else None
    before = tfa.LAUNCHES[kernel]
    out = fn(ois)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[kernel] == before + 1
    _check_attn(out, plain(ois), "bf16", quant)


# L, (kh, kw) or None, and the kernel JAX's dispatch would reach
# (tests/test_torch_flash_attention.py::test_route_matches_jax_dispatch holds
# the port's route against JAX's on the CPU).
HEAD_SPLIT_CASES = [
    (1, (1, 1), "flash_whole"), (1, None, "flash_whole"),
    (63, (7, 9), "flash_whole"), (63, None, "flash_whole"),
    (64, (8, 8), "flash_whole"), (64, None, "flash_whole"),
    (197, (1, 197), "flash_whole"), (197, None, "flash_whole"),
    (196, (14, 14), "flash_whole"), (196, None, "flash_whole"),
    (512, (16, 32), "flash_whole"), (512, None, "flash_whole"),
    (800, (25, 32), "flash_rowblock"), (800, None, "flash_rowblock"),
    (2500, (50, 50), "flash_rowblock"), (2500, None, "flash_rowblock"),
    (4096, (16, 256), "flash_rowblock"), (4096, None, "flash_rowblock"),
]


# float32 runs csrc/flash_attn.cu's register-tiled body: L 1, 63 and 197
# leave one row and key group of 16 in use in the last row block and key
# tile (the (IN, JN) variants), L 196 four rows and keys, L 2500 four of
# each past 39 whole tiles; hd 64 has no 16-column remainder in p.v, hd 80
# one. Each case is held to its bound, and the plain version with its last
# key tile left out of p.v must fail it.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("L,kv,name", HEAD_SPLIT_CASES)
def test_head_split_kernel_matches_plain(cuda, dtype, L, kv, name, hd):
    tdt = DTYPES[dtype][0]
    nh = 2
    q, k, v = (_randn(s, 1, nh, L, hd).to(cuda, tdt) for s in (7, 8, 9))
    rel = (None, None)
    if kv is not None:
        rel = tuple(_randn(s, 1, nh, L, n).to(cuda, tdt) for s, n in zip((10, 11), kv))
    before = dict(tfa.LAUNCHES)
    out = tfa.flash_attention_relpos(q, k, v, *rel, hd**-0.5)
    torch.cuda.synchronize()
    assert tfa.route(L, kv) == name
    assert {n: c - before[n] for n, c in tfa.LAUNCHES.items()} == {
        n: int(n == name) for n in tfa.LAUNCHES}
    assert out.dtype == tdt
    ref = tfa.flash_attention_plain(q, k, v, *rel, hd**-0.5)
    wrong = tfa.flash_attention_plain(q, k, _last_tile_skipped(v, L), *rel, hd**-0.5)
    if dtype == "f32":
        _check(out, ref, dtype, False)
        with pytest.raises(AssertionError):
            _check(wrong, ref, dtype, False)
    else:
        _check_hs(out, ref)
        _hs_fails(wrong, ref)


def _last_tile_skipped(v, L):
    """v with the last key tile (L % 64 keys, or 64) zeroed: the plain
    version on it is the negative control of a head-split-rule check."""
    skip = v.clone()
    skip[..., L - (L % 64 or 64):L, :] = 0
    return skip


# bfloat16 flash_rowblock runs the TMA tensor-core body (csrc/probe_tc.cuh):
# hd 64, 80 (unpadded, five k16 steps of q.k, m64n64k16 + m64n16k16 of p.v)
# and 128 (one m64n128k16), rel-less at a ragged L 1000, with a rel grid at
# kw 64 (the rel_w columns held in registers, L 576 = 9 x 64 not a multiple
# of 128, so not the bias3d kernel's) and at 50 x 50 (the per-stage index
# table).
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("L,kv", [(1000, None), (576, (9, 64)), (2500, (50, 50))])
def test_rowblock_bf16_body_matches_plain(cuda, hd, L, kv):
    bf = torch.bfloat16
    q, k, v = (_randn(s, 1, 2, L, hd).to(cuda, bf) for s in (80, 81, 82))
    rel = (None, None) if kv is None else tuple(
        _randn(s, 1, 2, L, n).to(cuda, bf) for s, n in zip((83, 84), kv))
    assert tfa.route(L, kv) == "flash_rowblock"
    before = dict(tfa.LAUNCHES)
    out = tfa.flash_attention_relpos(q, k, v, *rel, hd**-0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {**before, "flash_rowblock": before["flash_rowblock"] + 1}
    assert out.dtype == bf and out.shape == q.shape
    ref = tfa.flash_attention_plain(q, k, v, *rel, hd**-0.5)
    _check_hs(out, ref)
    _hs_fails(tfa.flash_attention_plain(q, k, _last_tile_skipped(v, L), *rel, hd**-0.5), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [80, 20])
def test_rowblock_all_below_floor_rows_on_card(cuda, hd):
    """bfloat16 flash_rowblock rows whose logits all lie below the clamp
    floor (|q|, |k| >= 8 with opposite signs: s <= -64 hd**0.5 log2 e):
    every real key gets p = 2^-124, absent keys none, so each row is the
    mean of the L = 1000 real values; |v| < 1/4 makes 2^-124 v subnormal,
    which the 2^64 carry keeps off the tensor cores. hd 20 also takes the
    wrapper's padding to 24 columns."""
    bf, L = torch.bfloat16, 1000
    q = (-(1 + _randn(85, 1, 2, L, hd).abs()) * 8).to(cuda, bf)
    k = ((1 + _randn(86, 1, 2, L, hd).abs()) * 8).to(cuda, bf)
    v = (_randn(87, 1, 2, L, hd).clamp(-1, 1) * 0.2).to(cuda, bf)
    ref = tfa.flash_attention_plain(q, k, v, None, None, hd**-0.5)
    mean = v.float().mean(dim=-2, keepdim=True)
    assert float((ref.float() - mean).abs().max()) <= 2.0**-8 * float(mean.abs().max())
    before = tfa.LAUNCHES["flash_rowblock"]
    out = tfa.flash_attention_relpos(q, k, v, None, None, hd**-0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_rowblock"] == before + 1 and out.shape == q.shape
    _check_hs(out, ref)
    _hs_fails(tfa.flash_attention_plain(q, k, _last_tile_skipped(v, L), None, None, hd**-0.5), ref)


# bfloat16 flash_whole runs the TMA tensor-core body (csrc/probe_tc.cuh) on
# short problems: head dims 16 (one depth step), 20 (rows TMA cannot
# address: the wrapper pads them to 24), 64, 80 and 128 (one m64n128k16 of
# p.v); L 196 = 3 x 64 + 4 (a last key tile of 4 real keys) with a 14 x 14
# rel grid (the per-stage index table) and without, L 25 (one short tile),
# and rel grids of kw 64 (rel_w pairs in registers, rh once a tile: L 512
# = 8 x 64, L 192 = 3 x 64).
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 20, 64, 80, 128])
@pytest.mark.parametrize("L,kv", [(196, (14, 14)), (196, None), (25, None), (512, (8, 64)),
                                  (192, (3, 64))])
def test_whole_bf16_body_matches_plain(cuda, hd, L, kv):
    bf = torch.bfloat16
    q, k, v = (_randn(s, 1, 3, L, hd).to(cuda, bf) for s in (104, 105, 106))
    rel = (None, None) if kv is None else tuple(
        _randn(s, 1, 3, L, n).to(cuda, bf) for s, n in zip((107, 108), kv))
    assert tfa.route(L, kv) == "flash_whole"
    before = dict(tfa.LAUNCHES)
    out = tfa.flash_attention_relpos(q, k, v, *rel, hd**-0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {**before, "flash_whole": before["flash_whole"] + 1}
    assert out.dtype == bf and out.shape == q.shape
    ref = tfa.flash_attention_plain(q, k, v, *rel, hd**-0.5)
    _check_hs(out, ref)
    _hs_fails(tfa.flash_attention_plain(q, k, _last_tile_skipped(v, L), *rel, hd**-0.5), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("rel", [False, True])
@pytest.mark.parametrize("hd", [80, 20])
def test_whole_all_below_floor_rows_on_card(cuda, hd, rel):
    """bfloat16 flash_whole rows whose logits all lie below the clamp floor:
    rel-less, |q|, |k| >= 8 with opposite signs (s <= -64 hd**0.5 log2 e);
    with a 14 x 14 rel grid, tiles of -50 (-72 each after log2 e). Every
    real key gets p = 2^-124, absent keys none, so each row is the mean of
    the L = 196 real values; |v| < 1/4 makes 2^-124 v subnormal, which the
    2^64 carry keeps off the tensor cores. hd 20 also takes the wrapper's
    padding to 24 columns."""
    bf, L, ws = torch.bfloat16, 196, 14
    if rel:
        q, k = (_randn(s, 1, 2, L, hd).to(cuda, bf) for s in (109, 110))
        rh, rw = (torch.full((1, 2, L, ws), -50.0, device=cuda, dtype=bf) for _ in range(2))
    else:
        q = (-(1 + _randn(109, 1, 2, L, hd).abs()) * 8).to(cuda, bf)
        k = ((1 + _randn(110, 1, 2, L, hd).abs()) * 8).to(cuda, bf)
        rh = rw = None
    v = (_randn(111, 1, 2, L, hd).clamp(-1, 1) * 0.2).to(cuda, bf)
    ref = tfa.flash_attention_plain(q, k, v, rh, rw, hd**-0.5)
    mean = v.float().mean(dim=-2, keepdim=True)
    assert float((ref.float() - mean).abs().max()) <= 2.0**-8 * float(mean.abs().max())
    before = tfa.LAUNCHES["flash_whole"]
    out = tfa.flash_attention_relpos(q, k, v, rh, rw, hd**-0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_whole"] == before + 1 and out.shape == q.shape
    _check_hs(out, ref)
    _hs_fails(tfa.flash_attention_plain(q, k, _last_tile_skipped(v, L), rh, rw, hd**-0.5), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("rel", [False, True])
@pytest.mark.parametrize("hd", [80, 18])
def test_whole_all_below_floor_rows_f32_on_card(cuda, hd, rel):
    """float32 flash_whole (the register-tiled body) on rows whose logits
    all lie below the clamp floor, as the bfloat16 case above builds them:
    every real key gets p = 2^-124 and absent keys none, so each row is the
    mean of the L = 196 real values (p v lies near the subnormal range, which
    the float32 FMAs keep). hd 18 also takes the wrapper's padding to 20."""
    L, ws = 196, 14
    if rel:
        q, k = (_randn(s, 1, 2, L, hd).to(cuda) for s in (112, 113))
        rh, rw = (torch.full((1, 2, L, ws), -50.0, device=cuda) for _ in range(2))
    else:
        q = (-(1 + _randn(112, 1, 2, L, hd).abs()) * 8).to(cuda)
        k = ((1 + _randn(113, 1, 2, L, hd).abs()) * 8).to(cuda)
        rh = rw = None
    v = (_randn(114, 1, 2, L, hd).clamp(-1, 1) * 0.2).to(cuda)
    ref = tfa.flash_attention_plain(q, k, v, rh, rw, hd**-0.5)
    mean = v.mean(dim=-2, keepdim=True)
    assert float((ref - mean).abs().max()) <= 1e-6
    before = tfa.LAUNCHES["flash_whole"]
    out = tfa.flash_attention_relpos(q, k, v, rh, rw, hd**-0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_whole"] == before + 1 and out.shape == q.shape
    _check(out, ref, "f32", False)
    with pytest.raises(AssertionError):
        _check(tfa.flash_attention_plain(q, k, _last_tile_skipped(v, L), rh, rw, hd**-0.5), ref,
               "f32", False)


@pytest.mark.gpu
def test_head_split_routes_pick_their_body_on_card(cuda, monkeypatch):
    """The wrapper passes the body to csrc/flash_attn.cu: in bfloat16 the TMA
    tensor-core one for both routes (flash_whole since it left the CUDA
    cores); float32 the register-tiled CUDA-core one in both."""
    from sam_quantization_tpu_torch.ops import _build

    seen, launch = [], _build.launch
    monkeypatch.setattr(_build, "launch", lambda name, *a: (seen.append((name, a[2])),
                                                            launch(name, *a))[1])
    for L, dtype, body in ((196, torch.float32, tfa.TILED_F32),
                           (196, torch.bfloat16, tfa.TMA_BODY),
                           (1000, torch.float32, tfa.TILED_F32),
                           (1000, torch.bfloat16, tfa.TMA_BODY)):
        q = _randn(88, 1, 2, L, 80).to(cuda, dtype)
        tfa.flash_attention_relpos(q, q, q, None, None, 0.125)
        assert seen.pop() == ("flash_attn", body), (L, dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("rel", [True, False])
def test_trainable_grads_equal_eager_on_card(cuda, rel):
    """The autograd Function's gradients are the eager function's, bit for
    bit: its backward is attention_reference's autograd on the same inputs."""
    B, nh, L, hd, g = 1, 4, 196, 80, 14
    tin = [_randn(s, B, nh, L, hd).to(cuda).requires_grad_() for s in (12, 13, 14)]
    if rel:
        tin += [(_randn(s, B, nh, L, g) * 0.3).to(cuda).requires_grad_() for s in (15, 16)]
    rest = tin[3:] if rel else [None, None]
    w = _randn(17, B, nh, L, hd).to(cuda)
    before = tfa.LAUNCHES["flash_whole"]
    out = tfa.flash_attention_relpos_trainable(*tin[:3], *rest, hd**-0.5)
    grads = torch.autograd.grad((out * w).sum(), tin)
    eager = torch.autograd.grad((tfa.attention_reference(*tin[:3], *rest, hd**-0.5) * w).sum(), tin)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_whole"] == before + 1
    for a, b in zip(grads, eager):
        assert torch.equal(a, b), float((a - b).abs().max())
    with torch.no_grad():
        _check(out, tfa.attention_reference(*tin[:3], *rest, hd**-0.5), "f32", False)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    qkv = torch.zeros(2, 25, 3 * 64, device=cuda, dtype=torch.float16)
    rel = torch.zeros(2, 4, 25, 10, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention_qkv_packed(qkv, rel, 0.25, nh=4, hd=16, kh=5, kw=5)
    qkv = torch.zeros(2, 3 * 64, 25, device=cuda).transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_qkv_packed(qkv, rel.float(), 0.25, nh=4, hd=16, kh=5, kw=5)


# ---------------------------------------------------------------------------
# Packed-weight kernels. Tolerances: float32 |d| <= 1e-5 |ref| + 1e-4 max|ref|
# (the same dequantized weights, float32 sums in another order); bfloat16
# |d| <= 8e-3 |ref| + 1e-3 max|ref| (two bf16 steps of an output: both sides
# multiply the same bf16 values and differ only in the f32 sum order, and in
# the fused MLP in an occasional one-step flip of a rounded hidden value).
# The bfloat16 bodies are the tensor-core ones of csrc/qmm_tc.cuh. Beside
# the first version's cases: ViT-H's shapes; K that is not a whole number of
# K tiles (K 352 at pack block 32: tiles of 128, 128 and 96 rows); and pack
# blocks that are not powers of two ("pb": groups of ODD_GROUP[bits], which
# default_pack_block packs in blocks of the group; K and H widen to their
# least common multiple with it), whose tiles are whole blocks (tile_rows:
# 96 rows at pack block 48, 120 at 12, padded to 128 for the 16-deep k
# steps, 80 at 80, 96 at 96).
# ---------------------------------------------------------------------------

QTOL = {"f32": (1e-5, 1e-4), "bf16": (8e-3, 1e-3)}
ODD_GROUP = {2: 80, 3: 96, 4: 48, 8: 12}


def _check_rel(out, ref, dtype):
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    rtol, mtol = QTOL[dtype]
    bound = rtol * np.abs(ref) + mtol * np.abs(ref).max()
    d = np.abs(out - ref)
    assert (d <= bound).all(), (d.max(), float((d - bound).max()))


def _packed(seed, K, N, bits, g, device, std=0.05):
    w = _randn(seed, K, N) * std
    return tpacked.quantize_rtn(w.to(device), bits, g, bias=_randn(seed + 1, N).to(device) * 0.01)


def _odd(K, g, bits):
    """The "pb" cases' groupsize, and K widened to a multiple of it."""
    if g != "pb":
        return K, g
    g = ODD_GROUP[bits]
    return K * g // math.gcd(K, g), g


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("M,K,N,g", [(64, 256, 128, 32), (100, 512, 192, 64), (37, 256, 250, 128),
                                     (130, 384, 128, 0), (1, 128, 64, 0), (4900, 1280, 3840, 128),
                                     (50, 352, 136, 0), (37, 256, 250, "pb")])
def test_quant_matmul_kernel_matches_plain(cuda, dtype, bits, M, K, N, g):
    tdt = DTYPES[dtype][0]
    odd = g == "pb"
    K, g = _odd(K, g, bits)
    p = _packed(10, K, N, bits, g, cuda)
    assert not odd or p.pack_block == g
    x = _randn(11, M, K).to(cuda, tdt)
    name = "quant_matmul3" if bits == 3 else "quant_matmul"
    before = dict(tqm.LAUNCHES)
    out = tqm.quant_matmul(x, p)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES[name] == before[name] + 1 and out.dtype == tdt
    _check_rel(out, tqm.quant_matmul_plain(x, p), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits,g", [(4, 128), (4, 32), (8, 64), (2, 0), (4, "pb"), (8, "pb"),
                                    (2, "pb")])
@pytest.mark.parametrize("M,K,H,N", [(64, 128, 512, 128), (45, 256, 1024, 384),
                                     (33, 128, 512, 1408),  # two column groups
                                     (4096, 1280, 5120, 1280)])
def test_fused_mlp_kernel_matches_plain(cuda, dtype, bits, g, M, K, H, N):
    tdt = DTYPES[dtype][0]
    odd = g == "pb"
    if odd:
        (K, _), (H, g) = _odd(K, g, bits), _odd(H, g, bits)
    p1, p2 = _packed(20, K, H, bits, g, cuda), _packed(22, H, N, bits, g, cuda)
    if M >= 4096:
        # At ViT-H's width b2 is left out, as chip_smoke.py's ViT-H case does:
        # it is added outside the kernel, in x's type, on both sides, and over
        # 5 M outputs its second rounding turns a one-step difference just
        # below a power of two into two or three steps of the lower binade.
        p2.bias = None
    assert not odd or (p1.pack_block, p2.pack_block) == (g, g)
    assert tfm.fused_mlp_supported(p1, p2)
    x = _randn(23, M, K).to(cuda, tdt)
    before = tfm.LAUNCHES["fused_mlp"]
    out = tfm.fused_mlp(x, p1, p2)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES["fused_mlp"] == before + 1
    ref = tfm.fused_mlp_plain(x, p1, p2)
    _check_rel(out, ref if p2.bias is None else ref + p2.bias.to(tdt), dtype)


@pytest.mark.gpu
def test_packed_kernels_reject_what_they_do_not_take(cuda):
    p = _packed(30, 128, 128, 4, 32, cuda)
    with pytest.raises(TypeError):
        tqm.quant_matmul(torch.zeros(4, 128, device=cuda, dtype=torch.float16), p)
    with pytest.raises(ValueError, match="contiguous"):
        tqm.quant_matmul(torch.zeros(128, 4, device=cuda).t(), p)
    with pytest.raises(ValueError, match="weights on cpu"):
        tqm.quant_matmul(torch.zeros(4, 128, device=cuda), _packed(30, 128, 128, 4, 32, "cpu"))
    # A pair that fails fused_mlp_supported (N % 128 != 0) runs the unfused
    # sequence, as JAX does: two dequant-matmul launches and no fused one.
    p1, p2 = _packed(31, 128, 512, 4, 32, cuda), _packed(32, 512, 96, 4, 32, cuda)
    x = _randn(33, 4, 128).to(cuda)
    before = {**tqm.LAUNCHES, **tfm.LAUNCHES}
    out = tfm.fused_mlp(x, p1, p2)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES["quant_matmul"] == before["quant_matmul"] + 2
    assert tfm.LAUNCHES["fused_mlp"] == before["fused_mlp"]
    want = p2(torch.nn.functional.gelu(p1(x)))
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# W-A8 kernels, on the same int8 input as their plain version. The integer
# sums are exact on both sides and the float32 epilogue runs in the same
# order, so the outputs agree to float32 rounding: |d| <= 1e-5 max|ref| in
# float32; in bfloat16 one output step, |d| <= 2**-7 |ref| + 1e-5 max|ref|.
# ---------------------------------------------------------------------------


def _packed_a8(seed, K, N, bits, g, sym, device):
    """RTN weights with int8 activations; asymmetric grids on skewed weights,
    so the zero points sit far from the middle (and from 128 at 8 bits)."""
    w = _randn(seed, K, N) * 0.05 + (0.0 if sym else 0.08)
    p = tpacked.quantize_rtn(w.to(device), bits, g, sym,
                             bias=_randn(seed + 1, N).to(device) * 0.01)
    return tpacked.with_act_bits(p, 8)


def _check_a8(out, ref, dtype):
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    peak = np.abs(ref).max() if ref.size else 0.0
    bound = (2.0**-7 * np.abs(ref) if dtype == "bf16" else 0.0) + 1e-5 * peak
    d = np.abs(out - ref)
    assert (d <= bound).all(), (d.max(), float((d - bound).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M,K,N,g", [(64, 256, 128, 32), (100, 512, 192, 64), (37, 256, 250, 128),
                                     (130, 384, 128, 0), (1, 128, 64, 0), (0, 128, 64, 32),
                                     # groups of 32 and 64 inside the 128-row K tile, and
                                     # M 1, 63, 65, 4900 against a ragged N: the TMA
                                     # zero-fill of the x tile and the masked epilogue
                                     (63, 384, 250, 32), (65, 384, 250, 64), (1, 384, 250, 128),
                                     (4900, 384, 250, 32)])
def test_a8_kernels_match_plain(cuda, dtype, sym, bits, M, K, N, g):
    tdt = DTYPES[dtype][0]
    p = _packed_a8(40, K, N, bits, g, sym, cuda)
    x = _randn(41, M, K).to(cuda, tdt)
    xq, xs = tqm.quantize_activations_int8(x)
    name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
    before = dict(tqm.LAUNCHES)
    out = tqm.a8_matmul(xq, xs, p, tdt, sym)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES[name] == before[name] + (M > 0) and out.dtype == tdt
    assert out.shape == (M, N)
    _check_a8(out, tqm.a8_matmul_plain(xq, xs, p, tdt, sym), dtype)
    # quant_matmul dispatches the layer (sym or not) to this kernel and
    # quantizes x to the same xq.
    assert torch.equal(tqm.quant_matmul(x, p), out)


# ViT-H's qkv (25 windows x 196 tokens) and lin2 (4096 global tokens, K
# 5120) at 4 bits, groups of 128, as W4A8 serves them; tolerance as above.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("M,K,N", [(4900, 1280, 3840), (4096, 5120, 1280)])
def test_a8_kernels_match_plain_at_vit_h(cuda, dtype, sym, M, K, N):
    tdt = DTYPES[dtype][0]
    p = _packed_a8(42, K, N, 4, 128, sym, cuda)
    xq, xs = tqm.quantize_activations_int8(_randn(43, M, K).to(cuda, tdt))
    name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
    before = dict(tqm.LAUNCHES)
    out = tqm.a8_matmul(xq, xs, p, tdt, sym)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES == {**before, name: before[name] + 1}
    assert out.dtype == tdt and out.shape == (M, N)
    _check_a8(out, tqm.a8_matmul_plain(xq, xs, p, tdt, sym), dtype)


def _sass_counts(name, pattern, instructions):
    """{instantiation key: [count of each instruction]} of the built library
    of ``csrc/<name>.cu``, read from ``cuobjdump -sass``."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from sam_quantization_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists() and shutil.which("cuobjdump") is None:
        pytest.skip("needs cuobjdump to read the kernels' SASS")
    _build.load(name)
    sass = subprocess.run([str(cuobjdump) if cuobjdump.exists() else "cuobjdump", "-sass",
                           str(_build.library_path(name))], capture_output=True, text=True,
                          check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            key = m.groups() if m else None
            if key:
                counts[key] = [0] * len(instructions)
        elif key:
            for i, ins in enumerate(instructions):
                if ins in line:
                    counts[key][i] += 1
    return counts


@pytest.mark.gpu
def test_a8_main_build_runs_int8_wgmma(cuda):
    """Every main-build instantiation of the W-A8 kernel (bits 2/4/8, sym and
    asym, float32 and bf16 out) holds IGMMA (int8 wgmma) and no IMMA; every
    FINE one holds IMMA (mma.sync)."""
    counts = _sass_counts("quant_matmul_a8",
                          r"qmm_a8_kernelILi(\d+)ELb(\d)ELb(\d)E(13__nv_bfloat16|f)E",
                          ("IGMMA", "IMMA"))
    assert len(counts) == 24, sorted(counts)
    for (bits, sym, fine, out), (igmma, imma) in counts.items():
        if fine == "1":
            assert imma > 0 and igmma == 0, (bits, sym, out, igmma, imma)
        else:
            assert igmma > 0 and imma == 0, (bits, sym, out, igmma, imma)


@pytest.mark.gpu
def test_a8_kernels_reject_what_they_do_not_take(cuda):
    p = _packed_a8(50, 128, 128, 4, 32, True, cuda)
    with pytest.raises(TypeError):
        tqm.quant_matmul(torch.zeros(4, 128, device=cuda, dtype=torch.float16), p)
    xq, xs = tqm.quantize_activations_int8(torch.zeros(4, 128, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tqm.a8_matmul(torch.zeros(128, 4, device=cuda, dtype=torch.int8).t(), xs, p,
                      torch.float32, True)
    with pytest.raises(TypeError, match="int8"):
        tqm.a8_matmul(xq.float(), xs, p, torch.float32, True)
    with pytest.raises(ValueError, match="weights on cpu"):
        tqm.quant_matmul(torch.zeros(4, 128, device=cuda), _packed_a8(50, 128, 128, 4, 32, True,
                                                                       "cpu"))
    with pytest.raises(ValueError, match="xs on cpu"):
        tqm.a8_matmul(xq, xs.cpu(), p, torch.float32, True)
    with pytest.raises(ValueError, match="not symmetric"):
        tqm.quant_matmul_a8_sym(torch.zeros(4, 128, device=cuda),
                                _packed_a8(51, 128, 128, 4, 32, False, cuda))


# Pack blocks that are not powers of two, in each of the five packed
# kernels: one launch, held against the plain version under the kernel's
# tolerance above (QTOL; the W-A8 kernels on the same int8 input, _check_a8).
# x (70, K) with K 384 (320 at pack block 80), N 250 (ragged).
PACK_BLOCK_CASES = [("quant_matmul", 4, 48), ("quant_matmul", 8, 12), ("quant_matmul", 2, 80),
                    ("quant_matmul3", 3, 96), ("fused_mlp", 4, 48), ("fused_mlp", 8, 12),
                    ("quant_matmul_a8_sym", 4, 48), ("quant_matmul_a8_sym", 8, 12),
                    ("quant_matmul_a8", 4, 48), ("quant_matmul_a8", 8, 12)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,bits,g", PACK_BLOCK_CASES)
def test_packed_kernels_take_any_pack_block_on_card(cuda, dtype, name, bits, g):
    tdt = DTYPES[dtype][0]
    K = 320 if g == 80 else 384
    x = _randn(61, 70, K).to(cuda, tdt)
    counters = tfm.LAUNCHES if name == "fused_mlp" else tqm.LAUNCHES
    before = dict(counters)
    if name == "fused_mlp":
        H = 1536  # a multiple of 512 and of the group
        p1, p2 = _packed(62, K, H, bits, g, cuda), _packed(63, H, 256, bits, g, cuda)
        assert (p1.pack_block, p2.pack_block) == (g, g) and tfm.fused_mlp_supported(p1, p2)
        out = tfm.fused_mlp(x, p1, p2)
        ref = tfm.fused_mlp_plain(x, p1, p2) + p2.bias.to(tdt)
    elif name.startswith("quant_matmul_a8"):
        sym = name == "quant_matmul_a8_sym"
        p = _packed_a8(64, K, 250, bits, g, sym, cuda)
        assert p.pack_block == g
        xq, xs = tqm.quantize_activations_int8(x)
        out = tqm.a8_matmul(xq, xs, p, tdt, sym)
        ref = tqm.a8_matmul_plain(xq, xs, p, tdt, sym)
    else:
        p = _packed(65, K, 250, bits, g, cuda)
        assert p.pack_block == g
        out = tqm.quant_matmul(x, p)
        ref = tqm.quant_matmul_plain(x, p)
    torch.cuda.synchronize()
    assert counters == {**before, name: before[name] + 1}
    assert out.dtype == tdt and out.shape == ref.shape
    if name.startswith("quant_matmul_a8"):
        _check_a8(out, ref, dtype)
    else:
        _check_rel(out, ref, dtype)


# Groups that end inside the kernels' 32-deep k steps (the FINE
# instantiation): groupsize 16 at K 64 (x (5, 64)), 8 (4-bit), 4 (8-bit:
# eight segments a step), 144 (a group across the 128-row K tiles, a
# boundary mid step) and 16 at K 272 (a last k step half past K) with
# ragged M and N.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,M,K,N,g", [(4, 5, 64, 128, 16), (4, 64, 96, 128, 8),
                                          (8, 33, 96, 128, 4), (2, 70, 288, 128, 144),
                                          (4, 130, 272, 250, 16)])
def test_a8_groups_below_the_k_step_on_card(cuda, dtype, sym, bits, M, K, N, g):
    """The W-A8 kernel splits a k step at a group boundary: one launch,
    held against its plain version on the same int8 input with the W-A8
    tolerance above, and quant_matmul dispatches the layer to it."""
    tdt = DTYPES[dtype][0]
    p = _packed_a8(53 + sym + bits, K, N, bits, g, sym, cuda)
    assert p.groupsize == g and g % 32
    x = _randn(55, M, K).to(cuda, tdt)
    xq, xs = tqm.quantize_activations_int8(x)
    name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
    before = dict(tqm.LAUNCHES)
    out = tqm.a8_matmul(xq, xs, p, tdt, sym)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES == {**before, name: before[name] + 1}
    assert out.dtype == tdt and out.shape == (M, N)
    _check_a8(out, tqm.a8_matmul_plain(xq, xs, p, tdt, sym), dtype)
    assert torch.equal(tqm.quant_matmul(x, p), out)


# ---------------------------------------------------------------------------
# The stage probes' kernels (P1-P5), bfloat16 as the probes run them, with
# the head-split bound: |d| <= 2**-7 |ref| + HS_BF16_C max|ref| (both sides
# multiply the same bf16 values and sum in float32 in another order, so a
# rounded p, s or output may flip by one bf16 step).
# ---------------------------------------------------------------------------




# P1 on csrc/probe_tc.cuh's AUG policy: heads read in place from slices of
# a packed qkv through 4D tensor maps (hd 64, 80, 128; hd 16 and L 25 the
# smallest), rel widths that are not multiples of 8 (R 28, 14, 100: padded
# to 32, 16, 104; one and two rel atoms), L 196 = 3 x 64 + 4, 64 (one whole
# key tile), 65 (one key past it) and 300 (three row blocks); hd 20 and a
# qkv that starts 4 bytes past a 16-byte boundary take the wrapper's copy.
@pytest.mark.gpu
@pytest.mark.parametrize("nh,hd,L,R,offset", [
    (3, 80, 196, 28, 0), (4, 16, 25, 10, 0), (2, 64, 64, 14, 0), (2, 128, 65, 100, 0),
    (2, 80, 300, 28, 0), (2, 80, 196, 100, 0), (3, 64, 196, 14, 2), (2, 20, 196, 28, 0)])
def test_probe_no_softmax_kernel_matches_plain(cuda, nh, hd, L, R, offset):
    NW, C = 3, nh * hd
    flat = _randn(60, NW * L * 3 * C + offset).to(cuda, torch.bfloat16)
    qkv = flat[offset:].view(NW, L, 3 * C)
    rel = (_randn(61, NW, nh, L, R) * 0.3).to(cuda, torch.bfloat16)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]  # read in place
    before = tpr.LAUNCHES["probe_no_softmax"]
    out = tpr.probe_no_softmax(q, k, v, rel, hd**-0.5, nh=nh, hd=hd)
    torch.cuda.synchronize()
    assert tpr.LAUNCHES["probe_no_softmax"] == before + 1 and out.dtype == torch.bfloat16
    assert out.shape == (NW, L, C)
    ref = tpr.probe_no_softmax_plain(q, k, v, rel, hd**-0.5, nh=nh, hd=hd)
    _check_hs(out, ref)
    v_skip = v.clone()
    v_skip[:, L - (L % 64 or 64):] = 0  # the last key tile left out of p.v
    _hs_fails(tpr.probe_no_softmax_plain(q, k, v_skip, rel, hd**-0.5, nh=nh, hd=hd), ref)


PROBE_HEADS = [  # name, call on (q, k, v, rh, rw)
    ("probe_dots_floor", lambda q, k, v, rh, rw: tpr.probe_dots_floor(q, k, v),
     lambda q, k, v, rh, rw: tpr.probe_dots_floor_plain(q, k, v)),
    ("probe_presplit", lambda q, k, v, rh, rw: tpr.probe_presplit(q, k, v, True),
     lambda q, k, v, rh, rw: tpr.probe_presplit_plain(q, k, v, True)),
    ("probe_presplit", lambda q, k, v, rh, rw: tpr.probe_presplit(q, k, v, False),
     lambda q, k, v, rh, rw: tpr.probe_presplit_plain(q, k, v, False)),
    ("probe_pair", lambda q, k, v, rh, rw: tpr.probe_pair(q, k, v, False),
     lambda q, k, v, rh, rw: tpr.probe_pair_plain(q, k, v, False)),
    ("probe_pair", lambda q, k, v, rh, rw: tpr.probe_pair(q, k, v, True),
     lambda q, k, v, rh, rw: tpr.probe_pair_plain(q, k, v, True)),
    ("probe_pair_bias", lambda q, k, v, rh, rw: tpr.probe_pair_bias(q, k, v, rh, rw, False),
     lambda q, k, v, rh, rw: tpr.probe_pair_bias_plain(q, k, v, rh, rw, False)),
    ("probe_pair_bias", lambda q, k, v, rh, rw: tpr.probe_pair_bias(q, k, v, rh, rw, True),
     lambda q, k, v, rh, rw: tpr.probe_pair_bias_plain(q, k, v, rh, rw, True)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(PROBE_HEADS)))
@pytest.mark.parametrize("BH,L,D,kh,kw", [(4, 256, 128, 16, 16), (3, 200, 80, 10, 20),
                                          (2, 1024, 128, 32, 32), (3, 320, 64, 16, 20),
                                          (2, 96, 40, 8, 12), (2, 70, 20, 7, 10)])
def test_probe_heads_kernel_matches_plain(cuda, case, BH, L, D, kh, kw):
    """q scaled by D**-0.5 * log2(e) as the probes scale it; L 200 leaves a
    ragged last key tile, D 80 unpadded heads; L 1024 is 8 row blocks and 16
    key tiles of the tensor-core body (P3, P4), D 64 one p.v column chunk,
    D 40 three 16-column chunks inside one swizzle atom, D 20 rows that TMA
    cannot address (the wrapper pads them to 24 with zeros)."""
    name, kernel, plain = PROBE_HEADS[case]
    q = (_randn(62, BH, L, D) * (D**-0.5 * 1.4426950408889634)).to(cuda, torch.bfloat16)
    k, v = (_randn(s, BH, L, D).to(cuda, torch.bfloat16) for s in (63, 64))
    rh, rw = ((_randn(s, BH, L, n) * 0.5).to(cuda, torch.bfloat16) for s, n in ((65, kh), (66, kw)))
    before = tpr.LAUNCHES[name]
    out = kernel(q, k, v, rh, rw)
    torch.cuda.synchronize()
    assert tpr.LAUNCHES[name] == before + 1 and out.dtype == torch.bfloat16
    ref = plain(q, k, v, rh, rw)
    _check_hs(out, ref)
    if name == "probe_dots_floor":  # P2's negative control: the last key tile left out
        _hs_fails(plain(q, k, _last_tile_skipped(v, L), rh, rw), ref)


@pytest.mark.gpu
def test_probe_dots_floor_at_the_probe_shape_on_card(cuda):
    """P2 as tools/packed_probe.py runs it at ViT-H: 25 windows x 16 heads
    of 196 rows and hd 80, zero-padded to (400, 256, 128), q unscaled
    (logits of std ~9, any sign: round(s) is coarse and no probability).
    The padded keys take part with s = 0. One launch, the head-split bound,
    and the last real key tile (4 keys) left out rejected."""
    L, hd = 196, 80
    q, k, v = (torch.nn.functional.pad(_randn(s, 400, L, hd), (0, 128 - hd, 0, 256 - L))
               .to(cuda, torch.bfloat16) for s in (101, 102, 103))
    before = tpr.LAUNCHES["probe_dots_floor"]
    out = tpr.probe_dots_floor(q, k, v)
    torch.cuda.synchronize()
    assert tpr.LAUNCHES["probe_dots_floor"] == before + 1 and out.shape == q.shape
    ref = tpr.probe_dots_floor_plain(q, k, v)
    _check_hs(out, ref)
    _hs_fails(tpr.probe_dots_floor_plain(q, k, _last_tile_skipped(v, L)), ref)


def _probe_operands(seed, BH, L, D=128):
    """numpy q (scaled as the probes scale it), k, v of shape (BH, L, D)."""
    q = _randn(seed, BH, L, D).numpy() * (D**-0.5 * 1.4426950408889634)
    return [q, _randn(seed + 1, BH, L, D).numpy(), _randn(seed + 2, BH, L, D).numpy()]


def _bf16_on(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.bfloat16) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("row", ["nan", "subnormal"])
def test_probe_pair_clamp_edge_rows_on_card(cuda, row):
    """Clamp-40 rows (tests/test_torch_probes.py pins them on the CPU), through
    the last lane, whose k is 2 + (n % 8) / 16: row 5 of head 0 takes
    s = -44 k in [-107.25, -88], every p = 2^(s - 40) subnormal in float32, a
    finite sum p and an output within the head-split bound; or s = -100 k,
    where every p underflows to 0 and the row is NaN on both sides."""
    q, k, v = _probe_operands(67, 2, 200)
    k[..., -1] = 2 + (np.arange(200) % 8) / 16
    q[0, 5] = 0
    q[0, 5, -1] = -44.0 if row == "subnormal" else -100.0
    q, k, v = _bf16_on((q, k, v), cuda)
    before = tpr.LAUNCHES["probe_pair"]
    out = tpr.probe_pair(q, k, v, clamp=True)
    torch.cuda.synchronize()
    assert tpr.LAUNCHES["probe_pair"] == before + 1 and out.dtype == torch.bfloat16
    ref = tpr.probe_pair_plain(q, k, v, clamp=True)
    if row == "nan":
        assert torch.isnan(ref[0, 5]).all() and torch.isnan(out[0, 5]).all()
        out[0, 5], ref[0, 5] = 0, 0
    else:
        assert torch.isfinite(ref).all() and torch.isfinite(out).all()
        assert ref[0, 5].abs().max() > 0
    _check_hs(out, ref)


# P5 at L 4096: the ViT-H 64 x 64 grid (kw 64: rw pairs in registers, rh
# once a tile) and a 16 x 256 grid (the per-stage index table; its 128 x 272
# bias rows leave room for two ring stages, not four).
@pytest.mark.gpu
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("kh,kw", [(64, 64), (16, 256)])
def test_probe_pair_bias_at_long_grids_on_card(cuda, clamp, kh, kw):
    L = kh * kw
    q, k, v = _bf16_on(_probe_operands(90, 2, L), cuda)
    rh, rw = ((_randn(s, 2, L, n) * 0.5).to(cuda, torch.bfloat16) for s, n in ((91, kh), (92, kw)))
    before = tpr.LAUNCHES["probe_pair_bias"]
    out = tpr.probe_pair_bias(q, k, v, rh, rw, clamp)
    torch.cuda.synchronize()
    assert tpr.LAUNCHES["probe_pair_bias"] == before + 1 and out.dtype == torch.bfloat16
    ref = tpr.probe_pair_bias_plain(q, k, v, rh, rw, clamp)
    _check_hs(out, ref)
    _hs_fails(tpr.probe_pair_bias_plain(q, k, _last_tile_skipped(v, L), rh, rw, clamp), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("row", ["nan", "subnormal"])
@pytest.mark.parametrize("kh,kw", [(10, 20), (4, 64)])
def test_probe_pair_bias_clamp_edge_rows_on_card(cuda, row, kh, kw):
    """test_probe_pair_clamp_edge_rows_on_card's rows with a bias of -0.5
    on row 5 of head 0 (rw -1, rh 0.5): s = -44 k - 0.5 in [-107.75,
    -88.5], every p subnormal and the row finite; or s = -100 k - 0.5, every
    p 0 and the row NaN on both sides. The other rows take random tiles;
    kw 20 reads the index table, kw 64 the registers."""
    L = kh * kw
    q, k, v = _probe_operands(93, 2, L)
    k[..., -1] = 2 + (np.arange(L) % 8) / 16
    q[0, 5] = 0
    q[0, 5, -1] = -44.0 if row == "subnormal" else -100.0
    rh, rw = (_randn(s, 2, L, n).numpy() * 0.5 for s, n in ((94, kh), (95, kw)))
    rh[0, 5], rw[0, 5] = 0.5, -1.0
    q, k, v, rh, rw = _bf16_on((q, k, v, rh, rw), cuda)
    before = tpr.LAUNCHES["probe_pair_bias"]
    out = tpr.probe_pair_bias(q, k, v, rh, rw, clamp=True)
    torch.cuda.synchronize()
    assert tpr.LAUNCHES["probe_pair_bias"] == before + 1 and out.dtype == torch.bfloat16
    ref = tpr.probe_pair_bias_plain(q, k, v, rh, rw, clamp=True)
    wrong = tpr.probe_pair_bias_plain(q, k, _last_tile_skipped(v, L), rh, rw, clamp=True)
    if row == "nan":
        assert torch.isnan(ref[0, 5]).all() and torch.isnan(out[0, 5]).all()
        out[0, 5], ref[0, 5], wrong[0, 5] = 0, 0, 0
    else:
        assert torch.isfinite(ref).all() and torch.isfinite(out).all()
        assert ref[0, 5].abs().max() > 0
    _check_hs(out, ref)
    _hs_fails(wrong, ref)


PROBE_ROWMAX = {  # the row-max callers of the tensor-core body
    "presplit exp2": ("probe_presplit", lambda q, k, v: tpr.probe_presplit(q, k, v, True),
                      lambda q, k, v: tpr.probe_presplit_plain(q, k, v, True)),
    "presplit exp": ("probe_presplit", lambda q, k, v: tpr.probe_presplit(q, k, v, False),
                     lambda q, k, v: tpr.probe_presplit_plain(q, k, v, False)),
    "pair": ("probe_pair", lambda q, k, v: tpr.probe_pair(q, k, v, False),
             lambda q, k, v: tpr.probe_pair_plain(q, k, v, False)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(PROBE_ROWMAX))
@pytest.mark.parametrize("edge", ["dominant", "tied", "padded"])
def test_probe_rowmax_edge_rows_on_card(cuda, kernel, edge):
    """The row-max edge rows of tests/test_torch_probes.py: one dominant logit
    (s 256 above the rest: every other p underflows, the output is that
    key's v), tied logits at the max (s = 6 on every fifth key), and the last
    quarter of the keys zero-padded (they take part, s = 0)."""
    name, run, plain = PROBE_ROWMAX[kernel]
    q, k, v = _probe_operands(68, 2, 200)
    if edge == "padded":
        k[:, 150:], v[:, 150:] = 0, 0
    else:
        q[0, 5] = 0
        q[0, 5, -1] = 64.0 if edge == "dominant" else 2.0
        k[..., -1] = 0
        if edge == "dominant":
            k[0, 37, -1] = 4.0
        else:
            k[0, ::5, -1] = 3.0
    q, k, v = _bf16_on((q, k, v), cuda)
    before = tpr.LAUNCHES[name]
    out = run(q, k, v)
    torch.cuda.synchronize()
    assert tpr.LAUNCHES[name] == before + 1 and out.dtype == torch.bfloat16
    ref = plain(q, k, v)
    if edge == "dominant":
        assert torch.equal(ref[0, 5], v[0, 37]) and torch.equal(out[0, 5], v[0, 37])
    _check_hs(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("clamp", [False, True])
def test_probe_pair_takes_unaligned_operands_on_card(cuda, clamp):
    """Contiguous operands that start one element into their buffer, so not
    16-byte aligned as TMA needs: the wrapper copies them; one launch, within
    the head-split bound."""
    q, k, v = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
               for t in _bf16_on(_probe_operands(69, 2, 200), cuda))
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in (q, k, v))
    before = tpr.LAUNCHES["probe_pair"]
    out = tpr.probe_pair(q, k, v, clamp)
    torch.cuda.synchronize()
    assert tpr.LAUNCHES["probe_pair"] == before + 1 and out.dtype == torch.bfloat16
    _check_hs(out, tpr.probe_pair_plain(q, k, v, clamp))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["probe_pair_bias", "flash_rowblock"])
def test_tma_wrappers_take_unaligned_operands_on_card(cuda, kernel):
    """Operands that start one element into their buffer, and a head dim of
    20 (rows TMA cannot address): the wrappers pad to 24 columns and copy;
    one launch, within the head-split bound, the padded columns cut. P5 at
    L 200 on a 10 x 20 grid, flash_rowblock at L 1000, rel-less."""
    def unaligned(t):
        return torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)

    D = 20
    if kernel == "probe_pair_bias":
        L, shape = 200, (2, 200, D)
    else:
        L, shape = 1000, (1, 2, 1000, D)
    q, k, v = (unaligned(_randn(s, *shape).to(cuda, torch.bfloat16)) for s in (96, 97, 98))
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in (q, k, v))
    counts = tpr.LAUNCHES if kernel == "probe_pair_bias" else tfa.LAUNCHES
    before = counts[kernel]
    if kernel == "probe_pair_bias":
        rh, rw = (_randn(s, 2, L, n).to(cuda, torch.bfloat16) for s, n in ((99, 10), (100, 20)))
        out = tpr.probe_pair_bias(q, k, v, rh, rw, True)
        ref = tpr.probe_pair_bias_plain(q, k, v, rh, rw, True)
    else:
        out = tfa.flash_attention_relpos(q, k, v, None, None, D**-0.5)
        ref = tfa.flash_attention_plain(q, k, v, None, None, D**-0.5)
    torch.cuda.synchronize()
    assert counts[kernel] == before + 1
    assert out.shape == q.shape and out.is_contiguous() and out.dtype == torch.bfloat16
    _check_hs(out, ref)


@pytest.mark.gpu
def test_probe_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(2, 64, 32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        tpr.probe_pair(q, q, q, clamp=True)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        tpr.probe_dots_floor(qb.transpose(1, 2), qb.transpose(1, 2), qb.transpose(1, 2))
    with pytest.raises(ValueError, match="kh x kw"):
        tpr.probe_pair_bias(qb, qb, qb, qb[..., :7], qb[..., :8], clamp=False)
    # Bias rows of 128 x (1 + 600) values leave no room for two ring stages
    # of the tensor-core body: refused, with no other body to fall back to.
    q6 = torch.zeros(1, 600, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="probe_heads"):
        tpr.probe_pair_bias(q6, q6, q6, q6[..., :1].contiguous(),
                            torch.zeros(1, 600, 600, device=cuda, dtype=torch.bfloat16), True)
    q6 = q6[..., :80].reshape(1, 1, 600, 80).contiguous()
    with pytest.raises(RuntimeError, match="flash_attn"):
        tfa.flash_attention_relpos(q6, q6, q6, q6[..., :1].contiguous(),
                                   torch.zeros(1, 1, 600, 600, device=cuda, dtype=torch.bfloat16),
                                   0.125)
    qkv = torch.zeros(2, 25, 3 * 64, device=cuda, dtype=torch.bfloat16)
    rel = torch.zeros(2, 4, 25, 10, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="strides"):
        tpr.probe_no_softmax(qkv[..., :64], qkv[..., 64:128].contiguous(), qkv[..., 128:],
                             rel, 0.25, nh=4, hd=16)


# ---------------------------------------------------------------------------
# int8_matmul (torch._int_mm with the JAX package's epilogue): on the card it
# equals the CPU bit for bit on every branch, the integer sums being exact
# and every float step elementwise in the same order.
# ---------------------------------------------------------------------------


def _int_layer(seed, K, N, g, static, per_channel, transpose, device):
    r = np.random.default_rng(seed)
    w = torch.from_numpy((r.standard_normal((K, N)) * K**-0.5).astype(np.float32))
    mod = torch.nn.Module()
    mod.lin = tpacked.quantize_rtn(w, 4, g, True, bias=_randn(seed + 1, N) * 0.01)
    tpacked.cache_int8(mod, act_scales={"lin": 3.0} if static else None, skip=(),
                       per_channel=per_channel, transpose=transpose)
    return mod.lin.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("branch", ["static_nk", "static_kn", "dynamic_nk", "grouped", "pre"])
@pytest.mark.parametrize("M", [100, 5])
def test_int8_matmul_on_card_equals_cpu(cuda, dtype, branch, M):
    tdt = DTYPES[dtype][0]
    K, N = 256, 192
    kw = dict(static=branch in ("static_nk", "static_kn", "pre"),
              per_channel=branch != "grouped", transpose=branch != "static_kn")
    lin_cpu = _int_layer(70, K, N, 64, device="cpu", **kw)
    lin_gpu = _int_layer(70, K, N, 64, device=cuda, **kw)
    assert (lin_gpu.num_groups > 1) == (branch == "grouped")
    x = _randn(72, M, K) * 2
    x = torch.clamp(torch.round(x * 20), -127, 127).to(torch.int8) if branch == "pre" else x.to(tdt)
    out = tqm.int8_matmul(x.to(cuda), lin_gpu)
    ref = tqm.int8_matmul(x, lin_cpu)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == (M, N)
    assert torch.equal(out.cpu(), ref), float((out.cpu().float() - ref.float()).abs().max())


# The GPTQ solver on the card against the same solver on the CPU at a mid
# size (W4 g128), on rows mixed so that H has off-diagonal mass. Its
# library-ordered sums are float64, rounded once, so both devices compute
# the same grid (an H100 read it equal); the gates leave room for a float64
# difference that straddles a float32 rounding point: >= 99.9% of the grid
# equal, every difference one step, loss rel. 1e-3 (chip_smoke.py's gates).
@pytest.mark.gpu
@pytest.mark.parametrize("sym,actorder", [(False, False), (True, True)])
def test_gptq_solver_on_card_matches_cpu(cuda, sym, actorder):
    from sam_quantization_tpu_torch.quant import gptq as tgptq

    N, K = 512, 1024
    w = _randn(50, N, K) * 0.02
    z = _randn(51, 4096, K).to(cuda)
    x = z + z @ (_randn(52, K, K).to(cuda) / math.sqrt(K))
    h = (2.0 / 1) * (x.t() @ x)
    kw = dict(bits=4, groupsize=128, sym=sym, actorder=actorder)
    on_card = tgptq.gptq_quantize_matrix(w.to(cuda), h, **kw)
    on_cpu = tgptq.gptq_quantize_matrix(w, h.cpu(), **kw)
    assert on_card.q_int.is_cuda
    qg, qc = on_card.q_int.cpu(), on_cpu.q_int
    assert float((qg == qc).double().mean()) >= 0.999
    assert int((qg - qc).abs().max()) <= 1
    assert torch.equal(on_card.g_idx.cpu(), on_cpu.g_idx)
    assert abs(float(on_card.loss) - float(on_cpu.loss)) <= 1e-3 * abs(float(on_cpu.loss))


# A vit_tiny-shaped encoder whose MLP fuses (128 wide, MLP 512, 2 blocks),
# GPTQ W4 g32 on the card, written as an artifact and served as cli.infer
# --load serves it: every block linear on the packed kernels (qkv and proj
# quant_matmul, the MLP fused_mlp), float32 embedding against the same
# artifact's plain versions on the CPU within 1e-3 rel. L2 (each float32
# packed kernel may sit 1e-4 max|ref| from its plain version, chip_smoke.py's
# rel_ok; an H100 read 3.0e-4 over the two blocks and the neck).
@pytest.mark.gpu
def test_gptq_artifact_serves_through_packed_kernels_on_card(cuda, tmp_path):
    import copy
    import dataclasses

    from sam_quantization_tpu_torch.models import build_sam as tbuild
    from sam_quantization_tpu_torch.models import sam as tsam
    from sam_quantization_tpu_torch.models.configs import CONFIGS
    from sam_quantization_tpu_torch.quant import artifacts as tart
    from sam_quantization_tpu_torch.quant import sequential as tseq

    base = CONFIGS["vit_tiny"]
    cfg = dataclasses.replace(base, image_encoder=dataclasses.replace(
        base.image_encoder, embed_dim=128, depth=2, num_heads=4, global_attn_indexes=(1,)))
    model = tsam.init(cfg, 0, "cpu")
    for i, blk in enumerate(model.image_encoder.blocks):
        for t in (blk.attn.rel_pos_h, blk.attn.rel_pos_w):
            t.copy_(_randn(60 + i, *t.shape) * 0.2)
    batches = [_randn(70 + i, 1, 128, 128, 3).to(cuda) for i in range(2)]
    enc, losses = tseq.gptq_quantize_encoder(copy.deepcopy(model.image_encoder).to(cuda), batches,
                                             tseq.GPTQConfig(bits=4, groupsize=32))
    assert len(losses) == 8 and all(math.isfinite(v) for v in losses.values())
    tart.save_quantized(str(tmp_path), tbuild.to_jax_encoder(enc), {"method": "gptq", "wbits": 4})
    tree = tart.load_quantized(str(tmp_path))[0]
    on_cpu = tbuild.load_jax_encoder(copy.deepcopy(model), tree)
    on_card = tbuild.load_jax_encoder(copy.deepcopy(model).to(cuda), tree)
    x = _randn(80, 1, 128, 128, 3)
    before = {**tqm.LAUNCHES, **tfm.LAUNCHES}
    with torch.no_grad():
        out = tsam.encode_image(on_card, x.to(cuda)).cpu()
        torch.cuda.synchronize()
        ref = tsam.encode_image(on_cpu, x)
    assert tqm.LAUNCHES["quant_matmul"] == before["quant_matmul"] + 4
    assert tfm.LAUNCHES["fused_mlp"] == before["fused_mlp"] + 2
    assert float((out - ref).norm() / ref.norm()) <= 1e-3


# FQ-ViT on the card: vit_tiny calibrated there (PTF + LIS, minmax), then the
# quant-mode encode under FQCtx with attn_impl="kernel" launches no kernel
# (the context runs the eager branch, as JAX's FQ path reaches no Pallas
# kernel), while the same encoder under NULL_CTX launches its attention
# kernels; the card's quant-mode embedding (float32, TF32 off) against the
# CPU's from the same qparams within 1e-2 rel. L2
# (tests/test_torch_fq_encoder.py's tolerance).
@pytest.mark.gpu
def test_fq_context_launches_no_kernel_on_card(cuda):
    import copy

    from sam_quantization_tpu_torch.models import sam as tsam
    from sam_quantization_tpu_torch.models.configs import CONFIGS
    from sam_quantization_tpu_torch.quant.context import NULL_CTX
    from sam_quantization_tpu_torch.quant.fq import pipeline as tfq
    from sam_quantization_tpu_torch.quant.sequential import full_float32

    model = tsam.init(CONFIGS["vit_tiny"], 0, "cpu")
    enc = copy.deepcopy(model.image_encoder).to(cuda)
    cfg = tfq.FQConfig()
    batches = [_randn(90 + i, 1, 128, 128, 3).to(cuda) for i in range(2)]
    qparams = tfq.calibrate_encoder(enc, cfg, batches)
    qenc = tfq.fq_quantize_weights(enc, cfg)
    counters = (tfa.LAUNCHES, tqm.LAUNCHES, tfm.LAUNCHES, tpr.LAUNCHES)
    for mod in (tfa, tqm, tfm, tpr):
        mod.reset_launch_counts()
    ctx = tfq.FQCtx("quant", cfg, qparams=qparams)
    with torch.no_grad(), full_float32():
        out = qenc(batches[0], "kernel", ctx)
        torch.cuda.synchronize()
    assert all(n == 0 for c in counters for n in c.values())
    assert set(ctx.ln_modes.values()) == {"int"}
    with torch.no_grad():
        enc(batches[0], "kernel", NULL_CTX)
        torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_windowed"] == 2 and tfa.LAUNCHES["flash_whole"] == 2
    cpu_ctx = tfq.FQCtx("quant", cfg, qparams={k: tuple(v.cpu() for v in sz)
                                               for k, sz in qparams.items()})
    with torch.no_grad():
        ref = copy.deepcopy(qenc).cpu()(batches[0].cpu(), "eager", cpu_ctx)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-2
