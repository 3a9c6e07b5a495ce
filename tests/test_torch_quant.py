"""Port parity for the packed-weight modules and kernels, on the CPU.

The same integer grids and weights, drawn with numpy from a seed, go through
the JAX package and the port: packing is compared bit for bit, and the plain
kernel versions are held against the JAX Pallas kernels in interpret mode
(``quant_matmul.INTERPRET``, as ``tests/test_packed.py`` runs them).
Tolerances are stated where they are used. The quantized encoder and
predictor are in ``test_torch_quant_serving.py``.
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
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.ops import fused_mlp as tfused
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.quant import artifacts as tart
from sam_quantization_tpu_torch.quant import sequential as tseq


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _fields(p):
    """A JAX PackedLinear as the dict of its fields, arrays in numpy."""
    return {f.name: (None if getattr(p, f.name) is None else
                     np.asarray(getattr(p, f.name)) if isinstance(getattr(p, f.name), jax.Array)
                     else getattr(p, f.name))
            for f in dataclasses.fields(p)}


def _port_packed(jp) -> tpacked.PackedLinear:
    """The port's PackedLinear holding a JAX PackedLinear's words."""
    f = _fields(jp)
    p = tpacked.PackedLinear(f["in_features"], f["out_features"], bits=f["bits"],
                             groupsize=f["groupsize"], pack_block=f["pack_block"],
                             bias=f["bias"] is not None, act_bits=f["act_bits"], sym=f["sym"])
    for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
        if f[k] is not None:
            getattr(p, k).copy_(torch.from_numpy(np.array(f[k])))
    return p


def _interpret(fn, *args):
    jqm.INTERPRET = True
    try:
        return np.asarray(fn(*args))
    finally:
        jqm.INTERPRET = False


# ---------------------------------------------------------------------------
# nn/packed: bit-exact with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("K,groupsize", [(256, 0), (256, 128), (512, 64), (64, 0)])
def test_pack_and_rtn_match_jax_bit_for_bit(bits, K, groupsize):
    """pack_int_weights / unpack / dequantize / quantize_rtn give the JAX
    package's words, scales and zeros exactly (the cases of test_packed.py's
    test_pack_roundtrip)."""
    N = 128
    r = np.random.default_rng(bits * 1000 + K + groupsize)
    maxq = (1 << bits) - 1
    w_int = r.integers(0, maxq + 1, size=(K, N)).astype(np.int32)
    g = groupsize if groupsize > 0 else K
    scales = r.uniform(0.01, 0.1, size=(K // g, N)).astype(np.float32)
    zeros = r.integers(0, maxq + 1, size=(K // g, N)).astype(np.float32)
    jp = jpacked.pack_int_weights(w_int, scales, zeros, None, bits, groupsize)
    tp = tpacked.pack_int_weights(torch.from_numpy(w_int), torch.from_numpy(scales),
                                  torch.from_numpy(zeros), None, bits, groupsize)
    assert (tp.pack_block, tp.groupsize) == (jp.pack_block, jp.groupsize)
    np.testing.assert_array_equal(tp.qweight.numpy(), np.asarray(jp.qweight))
    if bits == 3:
        np.testing.assert_array_equal(tp.qweight_hi.numpy(), np.asarray(jp.qweight_hi))
    np.testing.assert_array_equal(tpacked.unpack_to_int(tp).numpy(), w_int)
    np.testing.assert_array_equal(tpacked.dequantize(tp).numpy(),
                                  np.asarray(jpacked.dequantize(jp)))

    w = r.normal(size=(K, N)).astype(np.float32)
    b = r.normal(size=(N,)).astype(np.float32)
    for sym in (False, True):
        jq = jpacked.quantize_rtn(jnp.asarray(w), bits, groupsize, sym, bias=jnp.asarray(b))
        tq = tpacked.quantize_rtn(torch.from_numpy(w), bits, groupsize, sym,
                                  bias=torch.from_numpy(b))
        for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
            if getattr(jq, k) is not None:
                np.testing.assert_array_equal(getattr(tq, k).numpy(), np.asarray(getattr(jq, k)),
                                              err_msg=f"{k} sym={sym}")
        assert tq.sym == jq.sym


def test_packed_buffers_stay_float32_under_to():
    """``module.to(torch.bfloat16)`` casts every floating buffer; a
    PackedLinear keeps its scales, zeros and bias as they were, float32 and
    bit for bit (the kernels dequantize with float32 scales, and a round trip
    through bfloat16 would round them), and its int32 words as they are."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=128).astype(np.float32))
    p = tpacked.quantize_rtn(w, 4, 32, bias=bias)
    before = {k: getattr(p, k).clone() for k in ("qweight", "scales", "zeros", "bias")}
    # The check has teeth: these values do change under a bfloat16 round trip.
    assert not torch.equal(before["scales"], before["scales"].bfloat16().float())
    assert not torch.equal(before["bias"], before["bias"].bfloat16().float())
    for cast in (lambda m: m.to(torch.bfloat16), lambda m: m.half(), lambda m: m.double()):
        cast(p)
        assert (p.scales.dtype, p.zeros.dtype, p.bias.dtype) == (torch.float32,) * 3
        for k, t in before.items():
            assert torch.equal(getattr(p, k), t), k
    model = tsam.init(TCONFIGS["vit_tiny"], 0, "cpu")
    tseq.rtn_quantize_encoder(model.image_encoder, tseq.GPTQConfig(bits=4, groupsize=32))
    qkv = model.image_encoder.blocks[0].attn.qkv
    scales, bias = qkv.scales.clone(), qkv.bias.clone()
    model.image_encoder.to(torch.bfloat16)
    qkv = model.image_encoder.blocks[0].attn.qkv
    assert torch.equal(qkv.scales, scales) and torch.equal(qkv.bias, bias)
    assert model.image_encoder.blocks[0].norm1.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("bits", [3, 4])
def test_dense_copy_is_the_packed_encoders_dense_model(bits):
    """``dense_copy`` (the reference chip_smoke holds the quantized ViT-H
    against) swaps every PackedLinear for a float32 Linear of its
    dequantized weight: same outputs on the eager path, float32 sums in
    another order (atol 1e-5), and the packed encoder is left as it was."""
    model = tsam.init(TCONFIGS["vit_tiny"], 0, "cpu")
    enc = tseq.rtn_quantize_encoder(model.image_encoder, tseq.GPTQConfig(bits=bits, groupsize=32))
    dense = tpacked.dense_copy(enc)
    blk = dense.blocks[0]
    assert not any(isinstance(m, tpacked.PackedLinear) for m in dense.modules())
    assert isinstance(enc.blocks[0].mlp.lin2, tpacked.PackedLinear)
    torch.testing.assert_close(blk.attn.qkv.weight.t(), tpacked.dequantize(enc.blocks[0].attn.qkv),
                               rtol=0, atol=0)
    x = torch.from_numpy(np.random.default_rng(bits).standard_normal((1, 128, 128, 3))
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(_np(dense(x, "eager")), _np(enc(x, "eager")), atol=1e-5)


# ---------------------------------------------------------------------------
# Plain kernel versions against the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,groupsize,bits", [
    (64, 256, 128, 128, 4),
    (100, 512, 256, 0, 4),   # ragged M (the Pallas wrapper pads to its block)
    (32, 256, 384, 64, 8),
    (48, 128, 256, 32, 2),
    (64, 256, 128, 128, 3),  # split-plane 3-bit (_qmm_kernel3)
    (37, 512, 256, 0, 3),
])
def test_quant_matmul_plain_matches_jax_kernel(M, K, N, groupsize, bits):
    """float32: the same dequantized weights, float32 sums over K in another
    order: |d| <= 1e-5 |ref| + 1e-4 (outputs are O(sqrt(K)) ~ 10-20)."""
    r = np.random.default_rng(M + K + N + bits)
    w = r.normal(size=(K, N)).astype(np.float32)
    x = r.normal(size=(M, K)).astype(np.float32)
    jp = jpacked.quantize_rtn(jnp.asarray(w), bits=bits, groupsize=groupsize)
    ref = _interpret(jqm.quant_matmul_pallas, jnp.asarray(x), jp)
    tp = _port_packed(jp)
    out = tqm.quant_matmul_plain(torch.from_numpy(x), tp)
    np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-4)
    before = dict(tqm.LAUNCHES)
    np.testing.assert_array_equal(_np(tqm.quant_matmul(torch.from_numpy(x), tp)), _np(out))
    assert tqm.LAUNCHES == before  # a CPU tensor takes the plain version, no launch


@pytest.mark.parametrize("M,K,H,bits,groupsize", [(64, 128, 512, 4, 128), (40, 256, 1024, 8, 0),
                                                  (24, 128, 512, 2, 32)])
def test_fused_mlp_plain_matches_jax_kernel(M, K, H, bits, groupsize):
    """float32, tanh GELU in both: sums over K and H in another order,
    |d| <= 1e-5 |ref| + 1e-5 (outputs are O(0.1))."""
    r = np.random.default_rng(M + K + H + bits)
    w1 = r.normal(size=(K, H)).astype(np.float32) * 0.05
    b1 = r.normal(size=(H,)).astype(np.float32) * 0.01
    w2 = r.normal(size=(H, K)).astype(np.float32) * 0.05
    b2 = r.normal(size=(K,)).astype(np.float32) * 0.01
    x = r.normal(size=(M, K)).astype(np.float32)
    j1 = jpacked.quantize_rtn(jnp.asarray(w1), bits, groupsize, bias=jnp.asarray(b1))
    j2 = jpacked.quantize_rtn(jnp.asarray(w2), bits, groupsize, bias=jnp.asarray(b2))
    assert jfused.fused_mlp_supported(j1, j2)
    ref = _interpret(jfused.fused_mlp, jnp.asarray(x), j1, j2)
    p1, p2 = _port_packed(j1), _port_packed(j2)
    out = tfused.fused_mlp(torch.from_numpy(x), p1, p2)
    np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-5)
    plain = tfused.fused_mlp_plain(torch.from_numpy(x), p1, p2) + p2.bias
    np.testing.assert_array_equal(_np(out), _np(plain))


def _zero_packed(K, N, bits, g, act_bits=0):
    """A JAX PackedLinear of zero words with the packing rule's static fields."""
    pb = jpacked.default_pack_block(K, bits)
    if g % pb:
        pb = jpacked.default_pack_block(g, bits)
    per = 16 if bits == 3 else 32 // bits
    return jpacked.PackedLinear(
        qweight=np.zeros((K // per, N), np.int32), scales=np.zeros((K // g, N), np.float32),
        zeros=np.zeros((K // g, N), np.float32), bias=None,
        qweight_hi=np.zeros((K // 32, N), np.int32) if bits == 3 else None, bits=bits,
        in_features=K, out_features=N, groupsize=g, pack_block=pb, act_bits=act_bits)


def _eligibility_case(K, H, N, bits1, bits2, g, act8):
    js = [_zero_packed(K, H, bits1, g), _zero_packed(H, N, bits2, g, 8 if act8 else 0)]
    return js, [_port_packed(j) for j in js]


@pytest.mark.parametrize("K,H,N,bits1,bits2,g,act8", [
    (128, 512, 128, 4, 4, 128, False),   # eligible
    (128, 512, 128, 4, 4, 32, False),    # eligible, grouped
    (128, 512, 128, 4, 8, 128, False),   # unequal bits
    (128, 512, 128, 3, 3, 128, False),   # 3-bit never fuses
    (128, 512, 128, 4, 4, 128, True),    # int8 activations
    (64, 256, 64, 4, 4, 32, False),      # H % 512 != 0 (vit_tiny)
    (128, 512, 96, 4, 4, 32, False),     # N % 128 != 0
    (1280, 5120, 1280, 4, 4, 128, False),  # ViT-H
])
def test_fused_mlp_supported_matches_jax(K, H, N, bits1, bits2, g, act8):
    (j1, j2), (t1, t2) = _eligibility_case(K, H, N, bits1, bits2, g, act8)
    assert tfused.fused_mlp_supported(t1, t2) == jfused.fused_mlp_supported(j1, j2)


def test_unported_paths_raise(tmp_path):
    """FQ-ViT artifacts name the slice that brings them, and a directory
    without an artifact says so. (W-A8 layers are served since their slice:
    ``tests/test_torch_quant_a8.py``.)"""
    qp = {"blocks": [{"attn": {"qkv": _zero_packed(64, 192, 4, 32)}}]}
    jart.save_quantized(str(tmp_path / "fq"), qp, {"method": "fq"})
    with pytest.raises(NotImplementedError, match="FQ-ViT"):
        tart.load_quantized(str(tmp_path / "fq"))
    jart.save_quantized(str(tmp_path / "w4"), qp, {"method": "rtn"})
    tree, _ = tart.load_quantized(str(tmp_path / "w4"))
    assert tart.is_packed(tree["blocks"][0]["attn"]["qkv"])
    with pytest.raises(FileNotFoundError):
        tart.load_quantized(str(tmp_path))
