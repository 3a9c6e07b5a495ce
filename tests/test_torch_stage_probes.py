"""Port parity: the stage-anatomy probes (``tools/block_anatomy``,
``attn_stage_probe``, ``mlp_serving_probe``, ``rel_probe``) and their carried
timer (``tools/timing.timed_carry``) against the JAX package's, on the CPU.

JAX's stages are nested in each tool's ``main`` and cannot be imported: they
are transcribed below, each with the lines it comes from. The port's stages
are the tools' own (``stages``, ``cases``, ``chains``, ``lowerings``), built
on the same weights: one windowed block of VIT_TINY (grid 8, window 5,
C 64, 4 heads), JAX's ``init_block(PRNGKey(0))`` in bfloat16 as the tools
make it, with its qkv bias and rel-pos tables drawn with numpy from a seed
(JAX's are zero), quantized by each package (RTN symmetric W4 g128, then
``cache_int8``). Inputs are drawn with numpy. JAX's windowed kernel runs in
interpret mode, the port's on its plain version.

JAX's stages run jitted, as its tools run them (inside a jitted scan).

Tolerance, bfloat16: |d| <= 2**-7 |ref| + C max|ref|. Both sides round the
same bf16 values, in another order of float32 sums (LayerNorm statistics,
products, the softmax), so an output may sit one step apart: C = 2**-10
(``tests/test_torch_probes.py``). Where a stage passes a bfloat16 GELU, JAX's
tanh form rounds each of its operations to bf16 and the port's
(``nn/functional.gelu``) rounds once, so 43% of its outputs differ by a step
or more and a product sums those steps: C = 2**-7. Where a stage quantizes
such an output (or a LayerNorm or attention output) to int8 at a static scale
of 8 / 127, a step apart flips an int8 value, and the product carries that
step: C = 2**-5.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam_quantization_tpu.ops.flash_attention as jfa
from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models.configs import VIT_TINY
from sam_quantization_tpu.nn import functional as JF
from sam_quantization_tpu.nn.packed import cache_int8 as jcache_int8
from sam_quantization_tpu.quant import gptq as jgptq
from sam_quantization_tpu.quant import sequential as jseq
from sam_quantization_tpu.quant.context import NULL_CTX
from sam_quantization_tpu_torch.models import image_encoder as tie
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.tools import (attn_stage_probe, block_anatomy,
                                              mlp_serving_probe, rel_probe, timing)

CFG = VIT_TINY.image_encoder
TCFG = TCONFIGS["vit_tiny"].image_encoder
C, WS, G, NH, HD = CFG.embed_dim, CFG.window_size, CFG.grid_size, CFG.num_heads, CFG.head_dim
NW, L = ((G + WS - 1) // WS) ** 2, WS * WS
C_BF16, C_GELU, C_INT8 = 2.0**-10, 2.0**-7, 2.0**-5
BF = jnp.bfloat16


def _close(out, ref, c=C_BF16, what=""):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(out).all()
    peak = np.abs(ref).max()
    d = np.abs(out - ref)
    bound = 2.0**-7 * np.abs(ref) + c * peak
    assert (d <= bound).all(), (what, float(d.max()), float(((d - bound) / peak).max()))


def _both(a: np.ndarray):
    """The same numpy array as a JAX and a torch bfloat16 operand."""
    return jnp.asarray(a, BF), torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()


def _randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def interpret(monkeypatch):
    """JAX's packed windowed kernel in interpret mode (as tests/test_torch_hoist.py)."""
    orig = jfa._fused_attention_qkv_packed
    monkeypatch.setattr(jfa, "_fused_attention_qkv_packed",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


# ---------------------------------------------------------------------------
# One windowed block in both packages
# ---------------------------------------------------------------------------


def _jax_block():
    """JAX's ``init_block(PRNGKey(0), cfg, 0)`` in bf16 (block_anatomy.py:87-90),
    its qkv bias and rel tables drawn with numpy."""
    bp = jie.init_block(jax.random.PRNGKey(0), CFG, 0)
    bp["attn"]["qkv"]["b"] = jnp.asarray(_randn(11, 3 * C, scale=0.1))
    for i, name in enumerate(("rel_pos_h", "rel_pos_w")):
        bp["attn"][name] = jnp.asarray(_randn(12 + i, *bp["attn"][name].shape, scale=0.2))
    return jax.tree_util.tree_map(lambda v: v.astype(BF) if v.dtype == jnp.float32 else v, bp)


def _port_block(bp) -> tie.Block:
    """A port ``Block`` holding JAX block ``bp``'s weights, in bf16."""
    blk = tie.Block(TCFG, 0, device="cpu")
    sd = {}
    for name in ("norm1", "norm2"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = bp[name]["w"], bp[name]["b"]
    for owner, name in (("attn", "qkv"), ("attn", "proj"), ("mlp", "lin1"), ("mlp", "lin2")):
        sd[f"{owner}.{name}.weight"] = bp[owner][name]["w"].T
        sd[f"{owner}.{name}.bias"] = bp[owner][name]["b"]
    for name in ("rel_pos_h", "rel_pos_w"):
        sd[f"attn.{name}"] = bp["attn"][name]
    blk.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    return blk.to(torch.bfloat16).eval()


def _jax_rtn(bp):
    """block_anatomy.py:94-95 / attn_stage_probe.py:75-76."""
    qcfg = jgptq.GPTQConfig(bits=4, groupsize=128, sym=True)
    return jseq.rtn_quantize_encoder({"blocks": [bp]}, qcfg)["blocks"][0]


@pytest.fixture(scope="module")
def blocks():
    """{tag: (JAX block, port block)} for block_anatomy's three sets and the
    attention probe's serving block."""
    bp = _jax_block()
    qbp = _jax_rtn(bp)
    dense = _port_block(bp)
    tsets = block_anatomy.param_sets(dense, int4=True, a8=True)
    jsets = {
        "bf16": bp, "int4-w": qbp,  # block_anatomy.py:92-105
        "a8-static": jcache_int8(qbp, act_scales={"attn.qkv": 8.0, "mlp.lin1": 8.0,
                                                  "mlp.lin2": 8.0}),
    }
    out = {tag: (jsets[tag], tsets[tag]) for tag in jsets}
    # attn_stage_probe.py:77-82
    out["serving"] = (jcache_int8(qbp, act_scales=dict(attn_stage_probe.ACT_SCALES), skip=()),
                      attn_stage_probe.serving_block(_port_block(bp)))
    return out


def test_port_quantizes_the_block_as_jax():
    """The port's RTN W4 g128 and cached int8 of the block give JAX's grids."""
    bp = _jax_block()
    jq = jcache_int8(_jax_rtn(bp), act_scales=dict(attn_stage_probe.ACT_SCALES), skip=())
    tq = attn_stage_probe.serving_block(_port_block(bp))
    for owner, name in (("attn", "qkv"), ("attn", "proj"), ("mlp", "lin1"), ("mlp", "lin2")):
        j, t = jq[owner][name], getattr(getattr(tq, owner), name)
        np.testing.assert_array_equal(np.asarray(j.w8), t.w8.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(j.scales, np.float32), t.scales.numpy())
        assert float(j.in_scale) == float(t.in_scale)


# ---------------------------------------------------------------------------
# block_anatomy: stages transcribed from tools/block_anatomy.py:107-152
# ---------------------------------------------------------------------------


def _jax_stages(p):
    def noop(x):
        return x

    def ln(x):
        return JF.layer_norm(p["norm1"], x, CFG.ln_eps)

    def partition(x):
        yw, pad_hw = jie.window_partition(x, WS)
        return jie.window_unpartition(yw, WS, pad_hw, (G, G))

    def qkv(x):
        yw, pad_hw = jie.window_partition(x, WS)
        nw = yw.shape[0]
        y = JF.linear(p["attn"]["qkv"], yw.reshape(nw, WS * WS, C))
        y3 = y.reshape(nw, WS * WS, 3, C)
        y = y3[:, :, 0] * jnp.tanh(y3[:, :, 1]) + y3[:, :, 2]
        return jie.window_unpartition(y.reshape(nw, WS, WS, C), WS, pad_hw, (G, G))

    def attn(x, impl):
        yw, pad_hw = jie.window_partition(x, WS)
        yw = jie.attention(p["attn"], yw, CFG, NULL_CTX, "attn", impl)
        return jie.window_unpartition(yw, WS, pad_hw, (G, G))

    def mlp(x):
        h = JF.layer_norm(p["norm2"], x, CFG.ln_eps)
        lin1, lin2 = p["mlp"]["lin1"], p["mlp"]["lin2"]
        assert not jie._use_fused_mlp(NULL_CTX, lin1, lin2, "auto")  # CPU: unfused
        return JF.linear(lin2, JF.gelu(JF.linear(lin1, h)))

    def full(x, impl="auto"):
        return jie.block_apply(p, x, CFG, 0, NULL_CTX, attn_impl=impl)

    return [
        ("noop", noop), ("ln", ln), ("partition", partition), ("part+qkv+mix", qkv),
        ("part+attn(eager)", lambda x: attn(x, "xla")),
        # block_anatomy.py:160-161 inserts it on a TPU; held here in interpret mode
        ("part+attn(flash)", lambda x: attn(x, "flash")),
        ("ln2+mlp", mlp),
        ("full block", lambda x: full(x, "flash")),
        ("full block (eager)", lambda x: full(x, "xla")),
    ]


GELU_STAGES = {"ln2+mlp", "full block", "full block (eager)"}


def _stage_c(tag, name):
    """The stage's tolerance: which of its outputs may sit a step apart."""
    if name not in GELU_STAGES and not (tag == "a8-static" and name == "part+attn(flash)"):
        return C_BF16
    return C_INT8 if tag == "a8-static" else C_GELU


@pytest.mark.parametrize("tag", ["bf16", "int4-w", "a8-static"])
def test_block_stages_match_jax(blocks, interpret, tag):
    jp, tp = blocks[tag]
    xj, xt = _both(_randn(1, 1, G, G, C))
    port = dict(block_anatomy.stages(tp, TCFG, on_card=True))
    names = []
    for name, f in _jax_stages(jp):
        with torch.no_grad():
            out = port[name](xt)
        _close(out, jax.jit(f)(xj), _stage_c(tag, name), f"{tag} {name}")
        names.append(name)
    assert [n for n, _ in block_anatomy.stages(tp, TCFG, on_card=True)] == names
    assert "part+attn(flash)" not in dict(block_anatomy.stages(tp, TCFG, on_card=False))


# ---------------------------------------------------------------------------
# attn_stage_probe: cases transcribed from tools/attn_stage_probe.py:98-192,
# the flat cases on (G, G, C) where JAX hard-codes (64, 64, C) (:123, :152)
# ---------------------------------------------------------------------------


def _jax_cases(sp, bp, wqkv, xw, x_grid):
    qkv_p, proj_p, mlp1 = sp["attn"]["qkv"], sp["attn"]["proj"], sp["mlp"]["lin1"]
    xflat = xw.reshape(NW * L, C)[: G * G].reshape(G, G, C)

    def consume(y):  # :102-112
        n = y.shape[1] // C
        acc = y[:, :C]
        for i in range(1, n):
            acc = acc + y[:, i * C: (i + 1) * C]
        return acc

    def proj_pre(x):  # :139-143
        xi = jnp.clip(jnp.round(x.astype(jnp.float32) * 16.0), -127, 127).astype(jnp.int8)
        y = JF.linear(proj_p, xi.reshape(NW * L, C))
        return y.reshape(NW, WS, WS, C).astype(BF)

    Rh = jie.get_rel_pos(WS, WS, bp["attn"]["rel_pos_h"]).astype(BF)  # :163-164
    Rw = jie.get_rel_pos(WS, WS, bp["attn"]["rel_pos_w"]).astype(BF)

    def rel_only(x):  # :166-171
        qg = x.reshape(NW, WS, WS, NH, HD)
        rel_h = jnp.einsum("bhwnc,hkc->bnhwk", qg, Rh)
        rel_w = jnp.einsum("bhwnc,wkc->bnhwk", qg, Rw)
        rel = jnp.concatenate([rel_h, rel_w], -1)
        return x + jnp.mean(rel).astype(x.dtype)

    def part_roundtrip(x):  # :179-181
        yw, pad_hw = jie.window_partition(x, WS)
        return jie.window_unpartition(yw, WS, pad_hw, (G, G))

    return [
        (lambda x: consume(JF.linear(qkv_p, x.reshape(NW * L, C))).reshape(NW, WS, WS, C), xw),
        (lambda x: consume(JF.linear(qkv_p, x.reshape(-1, C))).reshape(x.shape), xflat),
        (lambda x: consume(JF.linear({"w": wqkv}, x.reshape(NW * L, C)))
         .reshape(NW, WS, WS, C), xw),
        (lambda x: JF.linear(proj_p, x.reshape(NW * L, C)).reshape(NW, WS, WS, C), xw),
        (proj_pre, xw),
        (lambda x: consume(JF.linear(mlp1, x.reshape(-1, C))).reshape(x.shape), xflat),
        (lambda x: consume(JF.linear(mlp1, x.reshape(NW * L, C))).reshape(NW, WS, WS, C), xw),
        (rel_only, xw),
        (part_roundtrip, x_grid),
        (lambda x: jie.attention(sp["attn"], x, CFG, NULL_CTX, "attn", "flash"), xw),  # :189-191
    ]


ATTN_LABELS = [  # tools/attn_stage_probe.py:115-192, at M = NW * L and G * G
    f"qkv int8-static M={NW * L}", f"qkv int8-static M={G * G}", f"qkv bf16 dense M={NW * L}",
    f"proj int8-static M={NW * L}", f"proj int8-PRE M={NW * L} (+quant outside)",
    f"lin1 int8-static M={G * G}", f"lin1 int8-static M={NW * L}", "rel einsums (on x as q)",
    "partition round trip bf16", "FULL attn (qkv+rel+flash+proj)",
]


@pytest.mark.parametrize("case", range(len(ATTN_LABELS)), ids=ATTN_LABELS)
def test_attn_stage_case_matches_jax(blocks, interpret, case):
    (jsp, tsp), (jbp, _) = blocks["serving"], blocks["bf16"]
    xw = _randn(2, NW, WS, WS, C)
    wqkv = _randn(3, C, 3 * C, scale=0.02)
    x_grid = _randn(4, 1, G, G, C)
    jf, jx = _jax_cases(jsp, jbp, *(jnp.asarray(a, BF) for a in (wqkv, xw, x_grid)))[case]
    port = attn_stage_probe.cases(tsp, TCFG, *(_both(a)[1] for a in (wqkv, xw, x_grid)))
    assert [name for name, _, _ in port] == ATTN_LABELS
    name, tf, tx = port[case]
    assert tuple(tx.shape) == jx.shape
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(jx, np.float32))
    with torch.no_grad():
        out = tf(tx)
    # the FULL stage quantizes the attention output to int8 in the kernel
    _close(out, jax.jit(jf)(jx), C_INT8 if name.startswith("FULL") else C_BF16, name)


# ---------------------------------------------------------------------------
# mlp_serving_probe: chains transcribed from tools/mlp_serving_probe.py:67-134
# ---------------------------------------------------------------------------

MLP_C, MLP_H, MLP_M = 64, 256, 100


def _jax_chains(w1, w2):
    w1_8 = jnp.clip(jnp.round(w1 / jnp.max(jnp.abs(w1)) * 127), -127, 127).astype(jnp.int8)
    w2_8 = jnp.clip(jnp.round(w2 / jnp.max(jnp.abs(w2)) * 127), -127, 127).astype(jnp.int8)
    s1, s2 = jnp.full((MLP_H,), 1e-3, jnp.float32), jnp.full((MLP_C,), 1e-3, jnp.float32)
    b1, b2 = jnp.zeros((MLP_H,), jnp.float32), jnp.zeros((MLP_C,), jnp.float32)
    g, bln = jnp.ones((MLP_C,), jnp.float32), jnp.zeros((MLP_C,), jnp.float32)
    in_s1, in_s2 = jnp.float32(0.05), jnp.float32(0.05)
    dn = (((1,), (1,)), ((), ()))

    def dots(xq):  # :82-88
        a = jax.lax.dot_general(xq, w1_8, dn, preferred_element_type=jnp.int32)
        aq = jnp.clip(a >> 7, -127, 127).astype(jnp.int8)
        return jax.lax.dot_general(aq, w2_8, dn, preferred_element_type=jnp.int32)

    def chain(x):  # :96-116
        hln = JF.layer_norm({"w": g, "b": bln}, x, 1e-6)
        xq = jnp.clip(jnp.round(hln.astype(jnp.float32) * (1.0 / in_s1)), -127, 127
                      ).astype(jnp.int8)
        acc = jax.lax.dot_general(xq, w1_8, dn, preferred_element_type=jnp.int32
                                  ).astype(jnp.float32)
        h = (acc * (s1 * in_s1)[None, :] + b1[None, :]).astype(BF)
        h = JF.gelu(h)
        hq = jnp.clip(jnp.round(h.astype(jnp.float32) * (1.0 / in_s2)), -127, 127
                      ).astype(jnp.int8)
        acc2 = jax.lax.dot_general(hq, w2_8, dn, preferred_element_type=jnp.int32
                                   ).astype(jnp.float32)
        return (acc2 * (s2 * in_s2)[None, :] + b2[None, :]).astype(BF)

    w1b, w2b = w1.astype(BF).T, w2.astype(BF).T

    def chain_bf16(x):  # :123-133
        xf = x.astype(jnp.float32)
        mu = jnp.mean(xf, axis=-1, keepdims=True)
        var = jnp.var(xf, axis=-1, keepdims=True)
        hln = ((xf - mu) * jax.lax.rsqrt(var + 1e-6) * g + bln).astype(BF)
        h = jnp.dot(hln, w1b, preferred_element_type=jnp.float32) + b1[None, :]
        h = jax.nn.gelu(h.astype(BF).astype(jnp.float32), approximate=False)
        y = jnp.dot(h.astype(BF), w2b, preferred_element_type=jnp.float32) + b2[None, :]
        return y.astype(BF)

    return {
        # :90-93, the timed form of dots
        "dots": lambda z: (dots((z * 64).astype(jnp.int8)).astype(jnp.float32)
                           * 1e-6).astype(BF)[:, :MLP_C],
        "chain": chain, "bf16": chain_bf16,
    }


@pytest.mark.parametrize("name", ["dots", "chain", "bf16"])
def test_mlp_chain_matches_jax(name):
    w1 = _randn(5, MLP_H, MLP_C, scale=0.02)
    w2 = _randn(6, MLP_C, MLP_H, scale=0.02)
    # x wide enough that x * 64 saturates int8 in the dots chain
    xj, xt = _both(_randn(7, MLP_M, MLP_C, scale=2.0))
    ref = jax.jit(_jax_chains(jnp.asarray(w1), jnp.asarray(w2))[name])(xj)
    out = mlp_serving_probe.chains(torch.from_numpy(w1), torch.from_numpy(w2))[name](xt)
    if name == "dots":  # integer products on the same int8 operands: the same bits
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    else:  # the serving chain requantizes its bf16 tanh GELU's output
        _close(out, ref, C_INT8 if name == "chain" else C_BF16, name)


# ---------------------------------------------------------------------------
# rel_probe: lowerings transcribed from tools/rel_probe.py:68-136, on the
# tiles of the port's rel tables
# ---------------------------------------------------------------------------


def _jax_lowerings(Rh, Rw):
    kh = kw = WS

    def out_mix(rel, x):  # :66-71
        r = jnp.sum(rel, axis=(1, 3))
        return x + r[:, :, None].astype(x.dtype) * jnp.bfloat16(1e-3)

    def a_current(x):  # :73-78
        qg = x.reshape(NW, kh, kw, NH, HD)
        rel_h = jnp.einsum("bhwnc,hkc->bnhwk", qg, Rh)
        rel_w = jnp.einsum("bhwnc,wkc->bnhwk", qg, Rw)
        rel = jnp.concatenate([rel_h, rel_w], -1).reshape(NW, NH, L, kh + kw)
        return out_mix(rel, x)

    def b_rowmajor(x):  # :80-88
        qg = x.reshape(NW, kh, kw, NH, HD)
        rel_h = jnp.einsum("bhwnc,hkc->bhwnk", qg, Rh)
        rel_w = jnp.einsum("bhwnc,wkc->bhwnk", qg, Rw)
        rel = jnp.concatenate([rel_h, rel_w], -1)
        rel = rel.reshape(NW, L, NH, kh + kw).transpose(0, 2, 1, 3)
        return out_mix(rel, x)

    def c_unrolled(x):  # :90-105
        qg = x.reshape(NW, kh, kw, NH, HD)
        rel_h = jnp.stack([jnp.dot(qg[:, h], Rh[h].T) for h in range(kh)], axis=1)
        rel_w = jnp.stack([jnp.dot(qg[:, :, w], Rw[w].T) for w in range(kw)], axis=2)
        rel = jnp.concatenate([rel_h, rel_w], -1)
        rel = rel.reshape(NW, L, NH, kh + kw).transpose(0, 2, 1, 3)
        return out_mix(rel, x)

    def d_bigdot(x):  # :107-131
        Rall = jnp.concatenate([Rh.reshape(kh * kh, HD).T, Rw.reshape(kw * kw, HD).T], axis=1)
        qg = x.reshape(NW, L, NH, HD)
        full = jnp.einsum("blnc,ck->blnk", qg, Rall)
        fh = full[..., : kh * kh].reshape(NW, kh, kw, NH, kh, kh)
        fw = full[..., kh * kh:].reshape(NW, kh, kw, NH, kw, kw)
        ih, iw = jnp.arange(kh), jnp.arange(kw)
        rel_h = jnp.moveaxis(fh[:, ih, :, :, ih], 0, 1)
        rel_w = jnp.moveaxis(fw[:, :, iw, :, iw], 0, 2)
        rel = jnp.concatenate([rel_h, rel_w], -1)
        rel = rel.reshape(NW, L, NH, kh + kw).transpose(0, 2, 1, 3)
        return out_mix(rel, x)

    return dict(zip(rel_probe.NAMES, (a_current, b_rowmajor, c_unrolled, d_bigdot)))


@pytest.mark.parametrize("name", rel_probe.NAMES)
def test_rel_lowering_matches_jax(name):
    th, tw = (torch.from_numpy(_randn(20 + i, 2 * WS - 1, HD, scale=0.5)).bfloat16()
              for i in range(2))
    Rh, Rw = (jnp.asarray(tie.get_rel_pos(WS, WS, t).float().numpy(), BF) for t in (th, tw))
    xj, xt = _both(_randn(22, NW, L, NH * HD))
    ref = _jax_lowerings(Rh, Rw)[name](xj)
    out = rel_probe.lowerings(th, tw, NW=NW, nh=NH, hd=HD, ws=WS)[name](xt)
    _close(out, ref)
    # the probe's own cross-check bound against JAX's a_current
    assert float(np.abs(out.float().numpy() - np.asarray(
        _jax_lowerings(Rh, Rw)["a_current"](xj), np.float32)).max()) < 5e-2


# ---------------------------------------------------------------------------
# timed_carry against JAX's carried scan
# ---------------------------------------------------------------------------


def _jax_carry(f, x, iters, mix):
    """The scan bodies of block_anatomy.py:51-55 (``scale``) and
    rel_probe.py:34-39 (``blend``; attn_stage_probe.py:35-39 and
    mlp_serving_probe.py:43-47 are the same), returning the carry."""
    def body(x, _):
        if mix == "scale":
            return (f(x) * jnp.bfloat16(0.82)).astype(x.dtype), None
        y = f(x)
        return (y * jnp.bfloat16(0.9) + x * jnp.bfloat16(0.1)).astype(x.dtype), None

    return jax.lax.scan(body, x, None, length=iters)[0]


@pytest.mark.parametrize("mix", ["scale", "blend"])
def test_timed_carry_matches_jax_scan(blocks, mix):
    """Four applications of block_anatomy's part+qkv+mix stage, carried."""
    jp, tp = blocks["bf16"]
    xj, xt = _both(_randn(8, 1, G, G, C))
    jf = dict(_jax_stages(jp))["part+qkv+mix"]
    tf = dict(block_anatomy.stages(tp, TCFG, on_card=False))["part+qkv+mix"]
    got = timing.timed_carry(tf, xt, 4, timing.scale_mix if mix == "scale" else timing.blend_mix,
                             outer=1)
    assert got.eager_ms is None and got.carry is got.eager_carry and got.launches == {}
    _close(got.carry, _jax_carry(jf, xj, 4, mix))


def test_mixes_are_jax_bf16_products():
    """The mixes' float constants are JAX's bf16 scalars, and a bf16 product
    by one rounds as JAX's does."""
    assert [float(jnp.bfloat16(v)) for v in (0.82, 0.9, 0.1, 1e-3, 1.01)] == \
        [0.8203125, 0.8984375, 0.10009765625, 0.00099945068359375, 1.0078125]
    xj, xt = _both(_randn(9, 4096))
    yj, yt = _both(_randn(10, 4096))
    np.testing.assert_array_equal(timing.scale_mix(yt, xt).float().numpy(),
                                  np.asarray(yj * jnp.bfloat16(0.82), np.float32))
    blend = np.asarray(yj * jnp.bfloat16(0.9) + xj * jnp.bfloat16(0.1), np.float32)
    _close(timing.blend_mix(yt, xt), blend)


# ---------------------------------------------------------------------------
# The tools' printed rows
# ---------------------------------------------------------------------------

LABELS = {  # each JAX tool's rows in print order, on the CPU
    "block_anatomy": [  # block_anatomy.py:140-173, bf16 only
        "[vit_tiny windowed block, bf16]", "noop", "ln", "partition", "part+qkv+mix",
        "part+attn(eager)", "ln2+mlp", "full block", "full block (eager)"],
    "attn_stage_probe": [f"[vit_tiny attn-stage probe] NW={NW} L={L} C={C}", "scan floor",
                         *ATTN_LABELS],  # :96-192
    "mlp_serving_probe": [f"shapes M={MLP_M} C={MLP_C} H={MLP_H}", "carry floor",  # :143-155
                          "int8 dots only", "serving chain", "bf16 chain", "fusion headroom"],
    "rel_probe": [f"[rel probe] NW={NW} L={L} nh={NH} hd={HD} kh=kw={WS}", "scan floor",
                  *rel_probe.NAMES],  # :134-150
}
ARGS = {
    "block_anatomy": ["--model", "vit_tiny"],
    "attn_stage_probe": ["--model", "vit_tiny"],
    "mlp_serving_probe": ["--dim", str(MLP_C), "--hidden", str(MLP_H), "--m", str(MLP_M)],
    "rel_probe": ["--model", "vit_tiny"],
}
TOOLS = {"block_anatomy": block_anatomy, "attn_stage_probe": attn_stage_probe,
         "mlp_serving_probe": mlp_serving_probe, "rel_probe": rel_probe}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_main_prints_jax_rows(tool):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert TOOLS[tool].main(ARGS[tool] + ["--platform", "cpu", "--iters", "2"]) == 0
    lines = buf.getvalue().splitlines()
    want = LABELS[tool]
    assert len(lines) == len(want), lines
    for line, label in zip(lines, want):
        assert line.strip().startswith(label), (line, label)
        assert "nan" not in line and "inf" not in line, line
