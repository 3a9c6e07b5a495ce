"""The hoisted-windowed encoder path (``SAMQ_HOIST_PROJ``, ``SAMQ_HOIST_QKV``)
against the JAX package's, on the CPU.

JAX's ``tests/test_flash_attention.py`` pins its hoisted block to its
partition-first block; here the port's hoisted block is held to JAX's
hoisted block (its packed windowed kernel in interpret mode, the port's
windowed kernel on its plain version), and to the port's own
partition-first block, at VIT_TINY's grid 8 and window 5 (padded to 10: four
windows, 36 of their 100 slots padding), with a non-zero qkv bias and
non-zero rel-pos tables, so padded slots matter. The block's weights come
from ``jax.random.PRNGKey(3)`` as in JAX's test; the bias, the rel tables
and x are drawn with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam_quantization_tpu.ops.flash_attention as jfa
from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models.configs import VIT_TINY
from sam_quantization_tpu.nn import packed as jpacked
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import image_encoder as tie
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.quant.context import NullCtx

CFG = VIT_TINY.image_encoder
# Port vs JAX: float32, the same arithmetic but the windowed attention's
# sums in another order (interpret-mode Pallas kernel vs the port's plain
# version), as the encoder parity tests hold it (tests/test_torch_models.py).
JAX_ATOL = 1e-4
# Port hoisted vs port partition-first: the same operations on the same
# tokens; only the token count of the qkv / proj products differs (64 real
# tokens against 100 padded ones), which may change a float32 product's
# blocking, so a few ulps of the block's output.
SELF_ATOL = {torch.float32: 1e-5, torch.bfloat16: 0.0}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _fields(p):
    """A JAX PackedLinear as the dict of its fields, arrays in numpy."""
    return {f.name: np.asarray(v) if isinstance(v, jax.Array) else v
            for f in dataclasses.fields(p) for v in [getattr(p, f.name)]}


def _encoders(packed: bool):
    """(JAX encoder pytree, port model) holding the same weights: JAX's
    test block 0 (PRNGKey(3); qkv bias and rel tables drawn with numpy), its
    qkv and proj RTN W4 g32 where ``packed``."""
    r = np.random.default_rng(3)
    enc = jie.init(jax.random.PRNGKey(3), CFG)
    attn = enc["blocks"][0]["attn"]
    attn["qkv"]["b"] = jnp.asarray(r.standard_normal(3 * CFG.embed_dim).astype(np.float32) * 0.1)
    for name in ("rel_pos_h", "rel_pos_w"):
        attn[name] = jnp.asarray(r.standard_normal(attn[name].shape).astype(np.float32) * 0.2)
    if packed:
        for name in ("qkv", "proj"):
            attn[name] = jpacked.quantize_rtn(attn[name]["w"], 4, 32, bias=attn[name]["b"])
    tree = jax.tree_util.tree_map(np.asarray, enc)
    if packed:
        tree["blocks"][0]["attn"] = {**tree["blocks"][0]["attn"],
                                     **{n: _fields(attn[n]) for n in ("qkv", "proj")}}
    model = tbuild.load_jax_encoder(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), tree)
    return enc, model


def _x(seed=7):
    return np.random.default_rng(seed).standard_normal(
        (1, CFG.grid_size, CFG.grid_size, CFG.embed_dim)).astype(np.float32)


def _gates(monkeypatch, proj: bool, qkv: bool):
    for name, on in (("SAMQ_HOIST_PROJ", proj), ("SAMQ_HOIST_QKV", qkv)):
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)


def _port_block(model, x):
    blk = model.image_encoder.blocks[0]
    with torch.no_grad():
        return blk(torch.from_numpy(x) if isinstance(x, np.ndarray) else x, "kernel")


@pytest.mark.parametrize("packed,hoist_qkv", [(False, False), (False, True), (True, True)])
def test_hoisted_block_matches_jax_hoisted_block(monkeypatch, packed, hoist_qkv):
    """The port's hoisted block against JAX's hoisted block (JAX_ATOL) and
    against the port's partition-first block (SELF_ATOL), dense and with a
    packed qkv and proj (W4 g32, its bias split off the PackedLinear)."""
    enc, model = _encoders(packed)
    x = _x()
    orig = jfa._fused_attention_qkv_packed
    monkeypatch.setattr(jfa, "_fused_attention_qkv_packed",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    _gates(monkeypatch, True, hoist_qkv)
    assert jie._use_hoisted_windowed(jie.NULL_CTX, CFG, "flash", CFG.window_size)
    assert tie._use_hoisted_windowed(tie.NULL_CTX, model.config.image_encoder, "kernel",
                                     CFG.window_size)
    ref = jie.block_apply(enc["blocks"][0], jnp.asarray(x), CFG, 0, attn_impl="flash")
    calls = []
    hoisted = tie.Attention.forward_windowed_hoisted
    monkeypatch.setattr(tie.Attention, "forward_windowed_hoisted",
                        lambda self, *a, **kw: calls.append(1) or hoisted(self, *a, **kw))
    out = _port_block(model, x)
    assert calls == [1]
    np.testing.assert_allclose(_np(out), _np(ref), atol=JAX_ATOL)
    _gates(monkeypatch, False, False)
    first = _port_block(model, x)
    assert calls == [1]
    np.testing.assert_allclose(_np(out), _np(first), atol=SELF_ATOL[torch.float32], rtol=0)


def _int8_block(dtype):
    """A port block whose four linears are RTN W4 g32 symmetric, cached as
    int8 (``cache_int8``), proj at a static activation scale: in bfloat16
    the windowed kernel then writes proj's int8 input (int8-pre)."""
    gen = torch.Generator().manual_seed(5)
    blk = tie.Block(TCONFIGS["vit_tiny"].image_encoder, 0, gen=gen)
    r = np.random.default_rng(5)
    with torch.no_grad():
        blk.attn.qkv.bias.copy_(torch.from_numpy(r.standard_normal(blk.attn.qkv.bias.shape)
                                                 .astype(np.float32) * 0.1))
        for t in (blk.attn.rel_pos_h, blk.attn.rel_pos_w):
            t.copy_(torch.from_numpy(r.standard_normal(t.shape).astype(np.float32) * 0.2))
    for owner, name in tie.BLOCK_LINEARS:
        lin = getattr(getattr(blk, owner), name)
        setattr(getattr(blk, owner), name, tpacked.quantize_rtn(
            lin.weight.detach().t(), 4, 32, sym=True, bias=lin.bias.detach()))
    tpacked.cache_int8(blk, act_scales={"attn.proj": 2.5}, skip=())
    return blk.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hoist_qkv", [False, True])
def test_hoisted_cached_int8_block_matches_partition_first(monkeypatch, dtype, hoist_qkv):
    """A cached-int8 block (``IntLinear`` qkv with its bias split off, the
    int8-pre proj in bfloat16: the unpartition moves int8) hoisted against
    partition-first, SELF_ATOL."""
    blk = _int8_block(dtype)
    assert isinstance(blk.attn.qkv, tpacked.IntLinear) and blk.attn.proj.in_scale is not None
    x = torch.from_numpy(_x(9)).to(dtype)
    _gates(monkeypatch, False, False)
    with torch.no_grad():
        first = blk(x, "kernel")
        _gates(monkeypatch, True, hoist_qkv)
        tqm.reset_launch_counts()
        out = blk(x, "kernel")
    # bfloat16: proj takes the kernel's int8 output; float32 quantizes its own
    assert tqm.INT8_MATMULS["int8_matmul_pre"] == (dtype == torch.bfloat16)
    assert out.dtype == dtype and out.shape == first.shape
    np.testing.assert_allclose(_np(out), _np(first), atol=SELF_ATOL[dtype], rtol=0)


class _Hooked(NullCtx):
    """A context other than NullCtx itself, as FQ-ViT's ``FQCtx`` is."""


def test_gate_follows_jax(monkeypatch):
    """Off unless SAMQ_HOIST_PROJ=1; then on only for rel-pos windows of at
    most 512 tokens under NullCtx on the kernel branch, as JAX's gate (with
    the port's "kernel" for JAX's "flash")."""
    ecfg = TCONFIGS["vit_tiny"].image_encoder
    ws = ecfg.window_size
    _gates(monkeypatch, False, True)
    assert not tie._use_hoisted_windowed(tie.NULL_CTX, ecfg, "kernel", ws)
    _gates(monkeypatch, True, False)
    assert tie._use_hoisted_windowed(tie.NULL_CTX, ecfg, "kernel", ws)
    assert not tie._use_hoisted_windowed(tie.NULL_CTX, ecfg, "kernel", 0)
    assert not tie._use_hoisted_windowed(tie.NULL_CTX, ecfg, "kernel", 23)
    assert not tie._use_hoisted_windowed(tie.NULL_CTX, ecfg, "eager", ws)
    assert not tie._use_hoisted_windowed(tie.NULL_CTX, ecfg, "flash_train", ws)
    assert not tie._use_hoisted_windowed(_Hooked(), ecfg, "kernel", ws)  # an FQ-like context
    no_rel = dataclasses.replace(ecfg, use_rel_pos=False)
    assert not tie._use_hoisted_windowed(tie.NULL_CTX, no_rel, "kernel", ws)
    assert jie._use_hoisted_windowed(jie.NULL_CTX, CFG, "flash", ws)
    assert not jie._use_hoisted_windowed(jie.NULL_CTX, CFG, "flash", 23)
