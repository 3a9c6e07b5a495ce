"""Pack blocks that are not powers of two, on the CPU: the port against the
JAX package.

``default_pack_block`` packs a layer whose groupsize does not hold the
default block in blocks of the groupsize itself: 48 rows for groups of 48
(4 bits), 12 for groups of 12 (8 bits), 96 for groups of 96 (3 bits) and
80 for groups of 80 (2 bits). The port's packed-weight kernels walk K in
tiles of whole pack blocks (``tile_rows``), so they take such layers; here
the packing, an artifact's loading and the plain versions of the five
packed kernels are held against the JAX package at those pack blocks. The
plain versions are what the kernels are held to on the card
(``tests/test_torch_kernels_gpu.py``). Sizes stay small: K <= 384, N 128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.nn import packed as jpacked
from sam_quantization_tpu.ops import fused_mlp as jfused
from sam_quantization_tpu.ops import quant_matmul as jqm
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.ops import fused_mlp as tfused
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.quant import artifacts as tart

# bits, groupsize, K, and the pack block default_pack_block gives them
PACK_CASES = [(4, 48, 384, 48), (8, 12, 384, 12), (3, 96, 384, 96), (2, 80, 320, 80)]
N = 128


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_packed(jp) -> tpacked.PackedLinear:
    """The port's PackedLinear holding a JAX PackedLinear's words."""
    p = tpacked.PackedLinear(jp.in_features, jp.out_features, bits=jp.bits,
                             groupsize=jp.groupsize, pack_block=jp.pack_block,
                             bias=jp.bias is not None, act_bits=jp.act_bits, sym=jp.sym)
    for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
        if getattr(jp, k) is not None:
            getattr(p, k).copy_(torch.from_numpy(np.array(getattr(jp, k))))
    return p


def _interpret(fn, *args):
    jqm.INTERPRET = True
    try:
        return np.asarray(fn(*args).astype(jnp.float32))
    finally:
        jqm.INTERPRET = False


@pytest.mark.parametrize("pack_block,rows", [(128, 128), (64, 128), (4, 128), (48, 96),
                                             (12, 120), (96, 96), (80, 80), (36, 72),
                                             (124, 124), (40, 120), (20, 120)])
def test_tile_rows_are_whole_pack_blocks(pack_block, rows):
    """The kernels' K tile: the most whole pack blocks in 128 rows, an even
    number where the block is not a multiple of 8 (so that tiles start on
    16-byte boundaries of x), and the W-A8 segments cut at it."""
    assert tqm.tile_rows(pack_block) == rows
    assert rows % pack_block == 0 and rows <= 128
    K = 6 * pack_block
    segs = tqm.a8_segments(K, 2 * pack_block, pack_block)
    assert segs[0][0] == 0 and segs[-1][1] == K
    assert all(a < b for a, b in segs) and all(b == c for (_, b), (c, _) in zip(segs, segs[1:]))
    cuts = {a for a, _ in segs}
    assert set(range(0, K, rows)) <= cuts and set(range(0, K, 2 * pack_block)) <= cuts


@pytest.mark.parametrize("bits,g,K,pb", PACK_CASES)
def test_packing_at_pack_block_matches_jax(bits, g, K, pb, tmp_path):
    """pack_int_weights and quantize_rtn write JAX's words, scales and zeros
    bit for bit at these pack blocks, and a JAX-written artifact of such a
    layer loads in the port with its pack block and words as they are."""
    r = np.random.default_rng(bits * 100 + g)
    maxq = (1 << bits) - 1
    w_int = r.integers(0, maxq + 1, size=(K, N)).astype(np.int32)
    scales = r.uniform(0.01, 0.1, size=(K // g, N)).astype(np.float32)
    zeros = r.integers(0, maxq + 1, size=(K // g, N)).astype(np.float32)
    jp = jpacked.pack_int_weights(w_int, scales, zeros, None, bits, g)
    tp = tpacked.pack_int_weights(torch.from_numpy(w_int), torch.from_numpy(scales),
                                  torch.from_numpy(zeros), None, bits, g)
    assert jp.pack_block == tp.pack_block == pb
    np.testing.assert_array_equal(tp.qweight.numpy(), np.asarray(jp.qweight))
    if bits == 3:
        np.testing.assert_array_equal(tp.qweight_hi.numpy(), np.asarray(jp.qweight_hi))
    np.testing.assert_array_equal(tpacked.unpack_to_int(tp).numpy(), w_int)
    np.testing.assert_array_equal(tpacked.dequantize(tp).numpy(),
                                  np.asarray(jpacked.dequantize(jp)))

    w = r.normal(size=(K, N)).astype(np.float32)
    b = r.normal(size=(N,)).astype(np.float32)
    jq = jpacked.quantize_rtn(jnp.asarray(w), bits, g, bias=jnp.asarray(b))
    tq = tpacked.quantize_rtn(torch.from_numpy(w), bits, g, bias=torch.from_numpy(b))
    assert jq.pack_block == tq.pack_block == pb
    for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
        if getattr(jq, k) is not None:
            np.testing.assert_array_equal(getattr(tq, k).numpy(), np.asarray(getattr(jq, k)),
                                          err_msg=k)

    jart.save_quantized(str(tmp_path / "art"), {"blocks": [{"attn": {"qkv": jq}}]},
                        {"method": "rtn", "wbits": bits, "groupsize": g})
    tree, _ = tart.load_quantized(str(tmp_path / "art"))
    node = tree["blocks"][0]["attn"]["qkv"]
    assert (node["pack_block"], node["groupsize"], node["bits"]) == (pb, g, bits)
    for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
        if getattr(jq, k) is not None:
            np.testing.assert_array_equal(node[k], np.asarray(getattr(jq, k)), err_msg=k)


@pytest.mark.parametrize("bits,g,K,pb", PACK_CASES)
def test_quant_matmul_plain_at_pack_block_matches_jax_kernel(bits, g, K, pb):
    """quant_matmul_plain against JAX's quant_matmul_pallas in interpret mode
    (``_qmm_kernel``, ``_qmm_kernel3`` at 3 bits), x (20, K), float32: the
    same dequantized weights, float32 sums in another order, |d| <= 1e-5
    |ref| + 1e-4 (outputs are O(sqrt(K)))."""
    r = np.random.default_rng(bits + g)
    w = r.normal(size=(K, N)).astype(np.float32)
    x = r.normal(size=(20, K)).astype(np.float32)
    jp = jpacked.quantize_rtn(jnp.asarray(w), bits, g)
    tp = _port_packed(jp)
    assert tp.pack_block == pb
    ref = _interpret(jqm.quant_matmul_pallas, jnp.asarray(x), jp)
    out = tqm.quant_matmul_plain(torch.from_numpy(x), tp)
    np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-4)
    before = dict(tqm.LAUNCHES)
    assert torch.equal(tqm.quant_matmul(torch.from_numpy(x), tp), out)
    assert tqm.LAUNCHES == before  # a CPU tensor takes the plain version
    tqm.check_packed_on("quant_matmul", torch.device("cpu"), tp)  # no refusal of the layout


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,g,K,pb", [c for c in PACK_CASES if c[0] != 3])
def test_a8_plain_at_pack_block_matches_jax_kernel(sym, bits, g, K, pb):
    """The W-A8 kernels' plain version (its segments cut at the new K tiles)
    against JAX's _quant_matmul_a8_sym / _asym in interpret mode, x (20, K),
    float32: the integer sums are exact on both sides and only the grouping
    of the float32 segment terms differs, |d| <= 1e-5 max|ref|."""
    r = np.random.default_rng(bits * 3 + g + sym)
    w = r.normal(size=(K, N)).astype(np.float32) * 0.05 + (0.0 if sym else 0.08)
    x = r.normal(size=(20, K)).astype(np.float32)
    jp = dataclasses.replace(jpacked.quantize_rtn(jnp.asarray(w), bits, g, sym), act_bits=8)
    tp = _port_packed(jp)
    assert tp.pack_block == pb
    jfn = jqm._quant_matmul_a8_sym if sym else jqm._quant_matmul_a8_asym
    ref = _interpret(jfn, jnp.asarray(x), jp)
    out = tqm.quant_matmul(torch.from_numpy(x), tp)
    d = np.abs(_np(out) - ref)
    assert (d <= 1e-5 * np.abs(ref).max()).all(), float(d.max())


@pytest.mark.parametrize("bits,g,K,H,pb", [(4, 48, 96, 1536, 48), (8, 12, 96, 1536, 12),
                                           (2, 80, 160, 2560, 80)])
def test_fused_mlp_plain_at_pack_block_matches_jax(bits, g, K, H, pb):
    """fused_mlp_plain of an eligible pair at these pack blocks. JAX's fused
    kernel does not take them (its scale tiles assume groups that divide its
    512-row hidden tile: the interpret-mode call raises), so the reference
    is the kernel's function built from JAX's quant_matmul_xla:
    gelu_tanh(x @ W1 + b1) @ W2 + b2 in float32, |d| <= 1e-5 |ref| + 1e-5
    (outputs are O(0.1))."""
    r = np.random.default_rng(bits + g + K)
    w1 = r.normal(size=(K, H)).astype(np.float32) * 0.05
    w2 = r.normal(size=(H, N)).astype(np.float32) * 0.05
    b1 = r.normal(size=(H,)).astype(np.float32) * 0.01
    b2 = r.normal(size=(N,)).astype(np.float32) * 0.01
    x = r.normal(size=(16, K)).astype(np.float32)
    j1 = jpacked.quantize_rtn(jnp.asarray(w1), bits, g, bias=jnp.asarray(b1))
    j2 = jpacked.quantize_rtn(jnp.asarray(w2), bits, g, bias=jnp.asarray(b2))
    p1, p2 = _port_packed(j1), _port_packed(j2)
    assert (p1.pack_block, p2.pack_block) == (pb, pb) and tfused.fused_mlp_supported(p1, p2)
    jx = jnp.asarray(x)
    with pytest.raises(TypeError):  # JAX's fused kernel at such groups
        _interpret(jfused.fused_mlp, jx, j1, j2)
    h = jax.nn.gelu(jqm.quant_matmul_xla(jx, j1) + j1.bias, approximate=True)
    ref = np.asarray(jqm.quant_matmul_xla(h, j2) + j2.bias)
    out = tfused.fused_mlp(torch.from_numpy(x), p1, p2)
    np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-5)
    plain = tfused.fused_mlp_plain(torch.from_numpy(x), p1, p2) + p2.bias
    np.testing.assert_array_equal(_np(out), _np(plain))

