"""Port parity: the attention kernels' plain versions against the JAX
package's Pallas kernels (interpret mode, CPU). The CUDA kernels are held
against these plain versions in test_torch_kernels_gpu.py.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: float32 atol 1e-4 (same arithmetic, other summation order);
bfloat16 atol 2e-2 (a p or output rounding may flip by one bf16 step); the
int8 epilogue may differ by one step on at most 0.5% of the elements (a
rounding tie moved by the float32 order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.ops import flash_attention as jfa
from sam_quantization_tpu_torch.ops import flash_attention as tfa

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _windowed(seed, NW, nh, L, hd, kh, kw, qkv_std=0.5, rel_std=0.3):
    r = np.random.default_rng(seed)
    qkv = (r.standard_normal((NW, L, 3 * nh * hd)) * qkv_std).astype(np.float32)
    rel = (r.standard_normal((NW, nh, L, kh + kw)) * rel_std).astype(np.float32)
    return qkv, rel


def _global(seed, B, nh, L, hd, kh, kw):
    r = np.random.default_rng(seed)
    q, k = ((r.standard_normal((B, nh, L, hd)) * 0.5).astype(np.float32) for _ in range(2))
    v = r.standard_normal((B, nh, L, hd)).astype(np.float32)
    rel_h = (r.standard_normal((B, nh, L, kh)) * 0.3).astype(np.float32)
    rel_w = (r.standard_normal((B, nh, L, kw)) * 0.3).astype(np.float32)
    return q, k, v, rel_h, rel_w


def _j(a, dt):
    return jnp.asarray(a, dt)


def _t(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_int8_close(a, b):
    d = np.abs(_f32(a) - _f32(b))
    assert d.max() <= 1.0, d.max()
    assert (d > 0).mean() <= 0.005, (d > 0).mean()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd", [80, 64])
def test_windowed_plain_matches_jax(dtype, hd):
    jdt, tdt, atol = DTYPES[dtype]
    NW, nh, L, kh, kw = 3, 2, 196, 14, 14
    qkv, rel = _windowed(0, NW, nh, L, hd, kh, kw)
    ref = jfa.flash_attention_qkv_packed(
        _j(qkv, jdt), _j(rel, jdt), hd**-0.5, nh=nh, hd=hd, kh=kh, kw=kw, interpret=True
    )
    out = tfa.flash_attention_qkv_packed(
        _t(qkv, tdt), _t(rel, tdt), hd**-0.5, nh=nh, hd=hd, kh=kh, kw=kw
    )
    assert out.dtype == tdt and tuple(out.shape) == (NW, L, nh * hd)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_global_plain_matches_jax(dtype):
    jdt, tdt, atol = DTYPES[dtype]
    args = _global(1, 1, 2, 1024, 64, 32, 32)
    ref = jfa.flash_attention_relpos(
        *(_j(a, jdt) for a in args), 0.125, interpret=True, bias3d=True
    )
    out = tfa.flash_attention_relpos(*(_t(a, tdt) for a in args), 0.125)
    assert out.dtype == tdt and tuple(out.shape) == (1, 2, 1024, 64)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_epilogue_matches_jax(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    NW, nh, L, hd, kh, kw = 3, 2, 196, 80, 14, 14
    qkv, rel = _windowed(2, NW, nh, L, hd, kh, kw)
    plain = tfa.flash_attention_qkv_packed(
        _t(qkv, tdt), _t(rel, tdt), hd**-0.5, nh=nh, hd=hd, kh=kh, kw=kw
    )
    ois = 127.0 / float(plain.float().abs().max())
    ref = jfa.flash_attention_qkv_packed(
        _j(qkv, jdt), _j(rel, jdt), hd**-0.5, nh=nh, hd=hd, kh=kh, kw=kw,
        interpret=True, out_inv_scale=jnp.float32(ois),
    )
    out = tfa.flash_attention_qkv_packed(
        _t(qkv, tdt), _t(rel, tdt), hd**-0.5, nh=nh, hd=hd, kh=kh, kw=kw, out_inv_scale=ois
    )
    assert out.dtype == torch.int8 and ref.dtype == jnp.int8
    _assert_int8_close(out, ref)

    args = _global(3, 1, 2, 1024, 64, 32, 32)
    plain = tfa.flash_attention_relpos(*(_t(a, tdt) for a in args), 0.125)
    ois = 127.0 / float(plain.float().abs().max())
    ref = jfa.flash_attention_relpos(
        *(_j(a, jdt) for a in args), 0.125, interpret=True, bias3d=True,
        out_inv_scale=jnp.float32(ois),
    )
    out = tfa.flash_attention_relpos(*(_t(a, tdt) for a in args), 0.125, out_inv_scale=ois)
    assert out.dtype == torch.int8 and ref.dtype == jnp.int8
    _assert_int8_close(out, ref)


def test_clamp_never_nan():
    """Logits far outside [-60, 64] (q.k ~ +-4000) stay finite: the floor
    keeps every p >= 2^-124, so sum p > 0 and 1/sum p is finite."""
    r = np.random.default_rng(4)
    B, nh, L, hd, kh, kw = 1, 1, 256, 64, 16, 16
    q = -np.abs(r.standard_normal((B, nh, L, hd))).astype(np.float32) * 8.0
    k = np.abs(r.standard_normal((B, nh, L, hd))).astype(np.float32) * 8.0
    v = r.standard_normal((B, nh, L, hd)).astype(np.float32)
    rh, rw = np.zeros((B, nh, L, kh), np.float32), np.zeros((B, nh, L, kw), np.float32)
    for sign in (1.0, -1.0):
        out = tfa.flash_attention_relpos(
            _t(sign * q, torch.float32), _t(k, torch.float32), _t(v, torch.float32),
            _t(rh, torch.float32), _t(rw, torch.float32), hd**-0.5,
        )
        assert torch.isfinite(out).all()
        qkv = np.concatenate([sign * q[0, 0], k[0, 0], v[0, 0]], -1)[None]
        rel = np.zeros((1, 1, L, kh + kw), np.float32)
        out = tfa.flash_attention_qkv_packed(
            _t(qkv, torch.float32), _t(rel, torch.float32), hd**-0.5, nh=1, hd=hd, kh=kh, kw=kw
        )
        assert torch.isfinite(out).all()


def test_all_below_floor_rows_average_real_keys():
    """A row whose logits all lie below the clamp floor gets p = 2^-124 on
    every key. The port has no padded keys, so it returns the plain mean of
    the L values; the JAX windowed kernel pads L=196 to Lp=224 and its padded
    columns take their share of sum p, shrinking the row by L/Lp."""
    NW, nh, L, hd, kh, kw = 1, 1, 196, 64, 14, 14
    r = np.random.default_rng(5)
    q = -np.abs(r.standard_normal((L, hd))).astype(np.float32) * 8.0
    k = np.abs(r.standard_normal((L, hd))).astype(np.float32) * 8.0
    # |v| >= 1 keeps the products 2^-124 * v normal: CPU matmuls flush
    # subnormal products to zero, which would hide what is tested here.
    v = (np.sign(r.standard_normal((L, hd))) * (1 + np.abs(r.standard_normal((L, hd)))))
    v = v.astype(np.float32)
    qkv = np.concatenate([q, k, v], -1)[None]
    rel = np.zeros((NW, nh, L, kh + kw), np.float32)
    out = tfa.flash_attention_qkv_packed(
        _t(qkv, torch.float32), _t(rel, torch.float32), hd**-0.5, nh=nh, hd=hd, kh=kh, kw=kw
    )
    mean = np.broadcast_to(v.mean(0), (L, hd))
    np.testing.assert_allclose(out[0].numpy(), mean, atol=1e-6)
    ref = jfa.flash_attention_qkv_packed(
        jnp.asarray(qkv), jnp.asarray(rel), hd**-0.5, nh=nh, hd=hd, kh=kh, kw=kw,
        interpret=True,
    )
    ref = np.asarray(ref)[0]
    # JAX's own rounding at 2^-124 scale leaves it within 3e-3 of the
    # shrunk mean; the shrink itself is larger than that.
    np.testing.assert_allclose(ref, mean * (196 / 224), atol=5e-3)
    assert np.abs(ref - mean).max() > 2e-2


# ---------------------------------------------------------------------------
# Head-split attention with or without rel-pos: JAX's generic dispatch, items
# _attn_kernel (whole problems, L <= 512) and _attn_kernel_rowblock, against
# the port's flash_attn plain version.
# ---------------------------------------------------------------------------

HEAD_SPLIT_SHAPES = [  # B, nh, L, hd, kh, kw (kh = kw = 0: no rel-pos)
    (3, 2, 196, 80, 14, 14),  # ViT-H windowed, whole problems
    (1, 2, 800, 64, 25, 32),  # padded long sequence, row blocks
    (1, 2, 1024, 64, 32, 32),  # row blocks (JAX bias3d=False)
    (2, 2, 196, 64, 0, 0),  # rel-less, whole problems
    (1, 2, 1024, 64, 0, 0),  # rel-less, row blocks
    (1, 2, 520, 80, 0, 0),  # rel-less, row blocks, L ragged against 64 and 128
    (1, 2, 1000, 64, 0, 0),  # the same
]


def _head_split(seed, B, nh, L, hd, kh, kw):
    q, k, v, rel_h, rel_w = _global(seed, B, nh, L, hd, max(kh, 1), max(kw, 1))
    return (q, k, v, rel_h, rel_w) if kh else (q, k, v, None, None)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", HEAD_SPLIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_head_split_plain_matches_jax(dtype, shape):
    jdt, tdt, atol = DTYPES[dtype]
    hd = shape[3]
    args = _head_split(6, *shape)
    ref = jfa.flash_attention_relpos(
        *(None if a is None else _j(a, jdt) for a in args), hd**-0.5, interpret=True,
        bias3d=False,
    )
    out = tfa.flash_attention_plain(*(None if a is None else _t(a, tdt) for a in args), hd**-0.5)
    assert out.dtype == tdt and tuple(out.shape) == shape[:4]
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=atol, rtol=0)
    if tfa.route(shape[2], shape[4:] if shape[4] else None) != "flash_global":
        wrapped = tfa.flash_attention_relpos(
            *(None if a is None else _t(a, tdt) for a in args), hd**-0.5)
        assert torch.equal(wrapped, out)


ROUTE_CASES = [  # L, (kh, kw) or None
    (64, (8, 8)), (196, (14, 14)), (512, (16, 32)), (196, None), (512, None),
    (800, (25, 32)), (1024, (32, 32)), (2500, (50, 50)), (4096, (64, 64)),
    (4096, (16, 256)), (1024, None), (4096, None),
]


@pytest.mark.parametrize("L,kv", ROUTE_CASES)
def test_route_matches_jax_dispatch(L, kv, monkeypatch):
    """The port sends each problem to the kernel JAX's dispatch reaches:
    ``_fused_attention_bias3d`` (flash_global), ``_fused_attention`` with
    bw > 1 (flash_whole) or bw == 1 (flash_rowblock). The JAX kernels are
    replaced by recorders here, so no interpret-mode kernel runs."""
    seen = []

    def fused(qa, ka, v, *, L, bw, block_q, interpret, exp2=False, clamp=False):
        seen.append("flash_whole" if bw > 1 else "flash_rowblock")
        return jnp.zeros((qa.shape[0], qa.shape[1], v.shape[2]), qa.dtype)

    def bias3d(qs, ks, v, rel_h, rel_w, out_inv_scale, **kw):
        seen.append("flash_global")
        return jnp.zeros(qs.shape, qs.dtype)

    monkeypatch.setattr(jfa, "_fused_attention", fused)
    monkeypatch.setattr(jfa, "_fused_attention_bias3d", bias3d)
    B, nh, hd = 1, 2, 16
    q = jnp.zeros((B, nh, L, hd), jnp.float32)
    rel = (None, None) if kv is None else (jnp.zeros((B, nh, L, kv[0])),
                                            jnp.zeros((B, nh, L, kv[1])))
    jfa.flash_attention_relpos(q, q, q, *rel, 0.25)
    assert seen == [tfa.route(L, kv)]


# The body each route runs: float32 on the CUDA cores (the tensor cores
# would mean TF32), every route on csrc/flash_f32.cuh's register-tiled body;
# bfloat16 flash_global on csrc/flash_tc.cuh's, both counters of
# csrc/flash_attn.cu on the TMA body (csrc/probe_tc.cuh).
ROUTE_BODY = {("flash_global", torch.bfloat16): tfa.TC_BODY,
              ("flash_whole", torch.bfloat16): tfa.TMA_BODY,
              ("flash_rowblock", torch.bfloat16): tfa.TMA_BODY,
              ("flash_global", torch.float32): tfa.TILED_F32,
              ("flash_whole", torch.float32): tfa.TILED_F32,
              ("flash_rowblock", torch.float32): tfa.TILED_F32}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,kv", ROUTE_CASES)
def test_body_of_each_route(L, kv, dtype):
    name = tfa.route(L, kv)
    assert tfa.body(name, dtype) == ROUTE_BODY[name, dtype]


@pytest.mark.parametrize("name", ["flash_whole", "flash_rowblock"])
def test_head_split_counters_name_their_bodies(name):
    """csrc/flash_attn.cu's two counters: the register-tiled CUDA-core body
    in float32, the TMA tensor-core body in bfloat16; the float32 body is
    neither of the other two."""
    assert tfa.body(name, torch.float32) == tfa.TILED_F32
    assert tfa.body(name, torch.bfloat16) == tfa.TMA_BODY
    assert tfa.TILED_F32 not in (tfa.TMA_BODY, tfa.TC_BODY)


@pytest.mark.parametrize("dtype,hd,pad", [(torch.float32, 18, 2), (torch.float32, 80, 0),
                                          (torch.bfloat16, 20, 4), (torch.bfloat16, 80, 0)])
def test_row_operands_keep_the_function(dtype, hd, pad):
    """_build.tma_operands pads hd to whole 16-byte rows (4 float32 or 8
    bfloat16 values) and copies a tensor that does not start on 16 bytes;
    the plain version on what it gives, cut to hd, is the plain version on
    the original operands."""
    from sam_quantization_tpu_torch.ops import _build

    r = np.random.default_rng(7)
    L, kv = 49, (7, 7)
    base = torch.from_numpy(r.standard_normal((3 * 2 * L * hd + 1,)).astype(np.float32)).to(dtype)
    q, k, v = (base[1 + i * 2 * L * hd:1 + (i + 1) * 2 * L * hd].view(1, 2, L, hd)
               for i in range(3))  # starts 4 or 2 bytes past a 16-byte boundary
    rel = [torch.from_numpy(r.standard_normal((1, 2, L, n)).astype(np.float32)).to(dtype)
           for n in kv]
    qp, kp, vp = _build.tma_operands(q, k, v)
    assert qp.shape[-1] == hd + pad and qp.shape[-1] * qp.element_size() % 16 == 0
    assert all(t.data_ptr() % 16 == 0 for t in (qp, kp, vp))
    assert torch.equal(qp[..., :hd], q) and not qp[..., hd:].any()
    out = tfa.flash_attention_plain(qp, kp, vp, *rel, hd**-0.5)[..., :hd]
    ref = tfa.flash_attention_plain(q, k, v, *rel, hd**-0.5)
    tol = 1e-6 if dtype == torch.float32 else 2.0**-8
    assert float((out.float() - ref.float()).abs().max()) <= tol * float(ref.float().abs().max())


@pytest.mark.parametrize("rel", [True, False])
def test_trainable_grads_match_jax(rel):
    """flash_attention_relpos_trainable: gradients within 1e-5 of JAX's
    trainable function (interpret-mode kernel forward, eager-recompute vjp),
    and exactly the port's own attention_reference autograd."""
    from sam_quantization_tpu.ops.flash_attention import flash_attention_relpos_trainable as jtr

    shape = (2, 2, 196, 64, 14, 14) if rel else (2, 2, 196, 64, 0, 0)
    args = _head_split(17, *shape)
    w = np.random.default_rng(9).standard_normal(shape[:4]).astype(np.float32)
    n = 5 if rel else 3
    import jax

    jgrads = jax.grad(
        lambda *a: jnp.sum(jtr(*a, *([None, None] if not rel else []), 0.125, interpret=True)
                           * w),
        argnums=tuple(range(n)))(*(_j(a, jnp.float32) for a in args[:n]))
    tin = [_t(a, torch.float32).requires_grad_() for a in args[:n]]
    rest = tin[3:] if rel else [None, None]
    out = tfa.flash_attention_relpos_trainable(*tin[:3], *rest, 0.125)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tin)
    eager = torch.autograd.grad((tfa.attention_reference(*tin[:3], *rest, 0.125)
                                 * torch.from_numpy(w)).sum(), tin)
    for g, jg, e in zip(grads, jgrads, eager):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=0)
        assert torch.equal(g, e)
    ref = jfa.attention_reference(*(None if a is None else _j(a, jnp.float32) for a in args),
                                  0.125)
    np.testing.assert_allclose(
        tfa.attention_reference(*(None if a is None else _t(a, torch.float32) for a in args),
                                0.125).numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_head_split_all_below_floor_rows_average_real_keys():
    """The by-design divergence on the head-split routes: a rel-less row whose
    logits all lie below the clamp floor is the plain mean of the L = 196
    values in the port, and that mean shrunk by L/Lp = 196/256 in JAX, whose
    whole-problem kernel pads L to Lp = round_up(L, 128)."""
    B, nh, L, hd = 1, 1, 196, 64
    r = np.random.default_rng(5)
    q = -np.abs(r.standard_normal((B, nh, L, hd))).astype(np.float32) * 8.0
    k = np.abs(r.standard_normal((B, nh, L, hd))).astype(np.float32) * 8.0
    # |v| >= 1 keeps the products 2^-124 * v normal (CPU matmuls flush
    # subnormal products to zero).
    v = (np.sign(r.standard_normal((B, nh, L, hd)))
         * (1 + np.abs(r.standard_normal((B, nh, L, hd))))).astype(np.float32)
    out = tfa.flash_attention_relpos(*(_t(a, torch.float32) for a in (q, k, v)), None, None,
                                     hd**-0.5)
    mean = np.broadcast_to(v[0, 0].mean(0), (L, hd))
    np.testing.assert_allclose(out[0, 0].numpy(), mean, atol=1e-6)
    ref = jfa.flash_attention_relpos(*(jnp.asarray(a) for a in (q, k, v)), None, None,
                                     hd**-0.5, interpret=True)
    ref = np.asarray(ref)[0, 0]
    np.testing.assert_allclose(ref, mean * (196 / 256), atol=5e-3)
    assert np.abs(ref - mean).max() > 2e-2
