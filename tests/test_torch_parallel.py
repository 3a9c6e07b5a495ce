"""Port parity: the parallel package (``parallel/distributed``, ``mesh``,
``sp_attention``), the encoder's tensor- and sequence-parallel branches,
dp x tp training and the mesh AMG decode, against the JAX package on the CPU.

The JAX references run in this process on conftest's 8 virtual CPU devices.
The port's two-rank cases run in one gloo world of two processes, spawned
once for the file (``world``), which returns numpy results; it skips where
127.0.0.1 cannot bind, as ``tests/test_multiprocess.py`` does. Everything is
vit_tiny in float32 (4 heads of 16, global blocks of L 64, windowed of 25).
The weights are the port's seed-0 model with rel-pos tables drawn from a
seed (so the bias contributes), written as JAX's pytree by
``build_sam.to_jax_params`` and carried back by ``from_jax_params``: JAX's
own op-by-op init of vit_tiny takes about 17 s on the CPU. Quantized layers
go to JAX the same way, field by field. Tolerances are stated where they
are used.
"""

import dataclasses
import json
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sam_quantization_tpu.models import image_encoder as jenc
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.nn.packed import IntLinear as JIntLinear
from sam_quantization_tpu.nn.packed import PackedLinear as JPackedLinear
from sam_quantization_tpu.parallel import mesh as jmesh
from sam_quantization_tpu.parallel import sp_attention as jsp
from sam_quantization_tpu_torch.automatic_mask_generator import (
    SamAutomaticMaskGenerator as TGenerator,
)
from sam_quantization_tpu_torch.cli import train as tcli
from sam_quantization_tpu_torch.data import synthetic as tsynth
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.parallel import distributed as tdist
from sam_quantization_tpu_torch.parallel import mesh as tmesh
from sam_quantization_tpu_torch.parallel import sp_attention as tsp
from sam_quantization_tpu_torch.quant import sequential as tseq
from sam_quantization_tpu_torch.train import trainer as ttrainer
from sam_quantization_tpu_torch.utils import amg as tamg

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = TCONFIGS["vit_tiny"]
NH, HD = CFG.image_encoder.num_heads, CFG.image_encoder.head_dim
SIZE = CFG.image_encoder.img_size
TCFG = {"num_clicks": 3}
AMG_KW = {"points_per_side": 4, "points_per_batch": 16, "pred_iou_thresh": -1e9,
          "stability_score_thresh": 0.0}
AMG_TOL = {"pixels": 1e-3, "bbox": 1.0, "iou": 1e-4, "stability": 1e-3, "area": 0}


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_model():
    """The port's vit_tiny from seed 0, rel-pos tables drawn from seed 1
    (std 0.2), as a JAX ``Sam``."""
    tm = tsam.init(CFG, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for blk in tm.image_encoder.blocks:
        for t in (blk.attn.rel_pos_h, blk.attn.rel_pos_w):
            t.copy_(torch.randn(t.shape, generator=g) * 0.2)
    trees = [jax.tree_util.tree_map(jnp.asarray, t)
             for t in tbuild.to_jax_params(tm.state_dict(), CFG)]
    return jsam.Sam(*trees, config=JCONFIGS["vit_tiny"])


def _state_dict(jm):
    return tbuild.from_jax_params(_to_np(jm.image_encoder), _to_np(jm.prompt_encoder),
                                  _to_np(jm.mask_decoder), CFG)


def _jax_layer(layer):
    """A port ``PackedLinear`` / ``IntLinear`` as the JAX dataclass."""
    arr = lambda t: None if t is None else jnp.asarray(t.numpy())
    if isinstance(layer, tpacked.IntLinear):
        return JIntLinear(w8=arr(layer.w8), scales=arr(layer.scales), bias=arr(layer.bias),
                          in_scale=arr(layer.in_scale), groupsize=layer.groupsize,
                          layout=layer.layout)
    return JPackedLinear(qweight=arr(layer.qweight), qweight_hi=arr(layer.qweight_hi),
                         scales=arr(layer.scales), zeros=arr(layer.zeros), bias=arr(layer.bias),
                         bits=layer.bits, in_features=layer.in_features,
                         out_features=layer.out_features, groupsize=layer.groupsize,
                         pack_block=layer.pack_block, act_bits=layer.act_bits, sym=layer.sym)


def _port_model(sd):
    return tbuild.load_state_dict(tsam.Sam(CFG, device="cpu"), sd)


def _sp_inputs():
    rng = np.random.default_rng(2)
    B, L = 2, 64
    qkv = [rng.normal(size=(B, NH, L, HD)).astype(np.float32) for _ in range(3)]
    rel = [rng.normal(size=(B, NH, L, 8)).astype(np.float32) * 0.1 for _ in range(2)]
    return qkv, rel


def _train_batch():
    samples = list(tsynth.synthetic_samples(2, SIZE, 11))
    images = np.concatenate([im for im, _ in samples])
    gts = np.stack([gt for _, gt in samples]).astype(np.float32)
    rng = np.random.default_rng(4)
    coords = rng.uniform(8, SIZE - 8, size=(2, TCFG["num_clicks"], 2)).astype(np.float32)
    labels = np.array([[1, 0, 1], [1, 1, 0]], np.float32)
    return images, gts, coords, labels


def _amg_image():
    return (np.random.default_rng(0).random((96, 128, 3)) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# The two-rank world
# ---------------------------------------------------------------------------

WORKER = r"""
import pickle, sys
import numpy as np
import torch

from sam_quantization_tpu_torch.automatic_mask_generator import SamAutomaticMaskGenerator
from sam_quantization_tpu_torch.cli import train as tcli
from sam_quantization_tpu_torch.models import build_sam, sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS
from sam_quantization_tpu_torch.nn import packed
from sam_quantization_tpu_torch.parallel import distributed as D, mesh as M, sp_attention as SP
from sam_quantization_tpu_torch.quant import sequential as seq
from sam_quantization_tpu_torch.train import trainer

d, rank, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(2)
D.initialize("gloo", device="cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
             rank=rank)
inp = pickle.load(open(f"{d}/inputs.pkl", "rb"))
cfg = CONFIGS["vit_tiny"]
nh = cfg.image_encoder.num_heads
dp2, tp2 = M.make_mesh(tp=1), M.make_mesh(tp=2)
out = {"rank": rank, "dp": (dp2.get_local_rank("dp"), tp2.get_local_rank("tp"))}


def model():
    return build_sam.load_state_dict(tsam.Sam(cfg, device="cpu"), inp["sd"])


t = lambda a: torch.from_numpy(np.asarray(a))
grp = M.group_of(tp2)
with torch.no_grad():
    (q, k, v), (rh, rw) = [[t(a) for a in x] for x in inp["sp"]]
    out["sp_rel"] = SP.sp_attention(q, k, v, rh, rw, 16**-0.5, grp).numpy()
    out["sp_norel"] = SP.sp_attention(q, k, v, None, None, 16**-0.5, grp).numpy()
    x = t(inp["x"])

    enc = M.tp_pack_qkv(model().image_encoder, nh, 2)
    M.shard_params(enc, tp2, packed_qkv=True)
    out["qkv_shard"] = enc.blocks[0].attn.qkv.weight.numpy()
    with M.tensor_parallel(tp2):
        out["tp_dense"] = enc(x).numpy()

    enc = model().image_encoder
    with SP.sequence_parallel(tp2, min_len=64):
        out["sp_encoder"] = enc(x, "eager").numpy()

    enc = seq.rtn_quantize_encoder(model().image_encoder, seq.GPTQConfig(4, 32))
    M.shard_params(enc, tp2, packed_qkv=False)
    with M.tensor_parallel(tp2):
        out["tp_w4"] = enc(x).numpy()

    # per-token int8 row shards: W4A8, and cached int8 with no act scales
    # (one int8 grid a column, and the g32 groups kept)
    for tag in ("w4a8", "int8", "int8_g32"):
        enc = seq.rtn_quantize_encoder(model().image_encoder, seq.GPTQConfig(4, 32, sym=True))
        if tag == "w4a8":
            enc = packed.with_act_bits(enc, 8)
        else:
            packed.cache_int8(enc, skip=None, per_channel=tag == "int8")
        M.shard_params(enc, tp2)
        with M.tensor_parallel(tp2):
            out["tp_" + tag] = enc(x).numpy()

    refused = []
    enc = seq.rtn_quantize_encoder(model().image_encoder, seq.GPTQConfig(4, 0, sym=True))
    try:
        M.shard_params(enc, tp2)
    except ValueError as e:
        refused.append(str(e))
    out["refused"] = refused

sp_w = t(inp["sp_w"])
for tag, rel in (("rel", True), ("norel", False)):
    ins = [a.clone().requires_grad_(True) for a in (q, k, v, rh, rw)]
    o = SP.sp_attention(*ins[:3], ins[3] if rel else None, ins[4] if rel else None, 16**-0.5,
                        grp)
    (o * sp_w).sum().backward()
    out["sp_grad_" + tag] = [None if a.grad is None else a.grad.numpy() for a in ins]

out["loss_dict"] = D.reduce_loss_dict({"loss": 1.0 + rank, "iou": 0.25 * rank})

images, gts, coords, labels = [t(a) for a in inp["train"]]
tcfg = trainer.TrainConfig(num_clicks=3)
for name, mesh in (("dp2", dp2), ("tp2", tp2)):
    m = model()
    opt = trainer.make_optimizer(tcfg, m)
    if name == "tp2":
        opt = trainer.shard_for_training(m, opt, tcfg, mesh)
        rows = slice(0, 2)
    else:
        rows = slice(rank, rank + 1)
    step = trainer.make_train_step(tcfg, opt, mesh)
    aux = step(m, images[rows], gts[rows], torch.Generator(), clicks=(coords[rows], labels[rows]))
    out[name + "_loss"] = float(aux["loss"])
    out[name] = {n: M.gather_tensor(n, p.detach(), mesh, nh).numpy()
                 for n, p in m.named_parameters()}
    st = opt.state[m.image_encoder.blocks[0].attn.qkv.weight]
    out[name + "_qkv_mu"] = M.gather_tensor("image_encoder.blocks.0.attn.qkv.weight",
                                            st["exp_avg"], mesh, nh).numpy()

for tag, kw in (("packed", {}), ("crops", {"crop_n_layers": 1})):
    gen = SamAutomaticMaskGenerator(model(), mesh=dp2, **inp["amg_kw"], **kw)
    out["amg_" + tag] = gen.generate(inp["amg_image"])

import os
os.environ["WORLD_SIZE"] = "2"
out["cli"] = tcli.main(["vit_tiny", "--platform", "cpu", "--exp-dir", inp["exp_dir"], "--tp",
                        "2", "--steps-per-epoch", "2", "--num-clicks", "2", "--seed", "3"])
pickle.dump(out, open(f"{d}/out{rank}.pkl", "wb"))
D.destroy()
print(f"rank {rank} OK", flush=True)
"""


def _can_bind() -> bool:
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
        return True
    except OSError:
        return False


class World:
    """Two gloo ranks running ``script`` on ``inputs``; :meth:`results`
    waits for both and returns their outputs."""

    def __init__(self, script: str, inputs: dict, tmp: pathlib.Path):
        if not _can_bind():
            pytest.skip("cannot bind 127.0.0.1 for a gloo world")
        self.tmp = tmp
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        port = tdist.free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", script, str(tmp), str(rank), str(port)], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
        self._out = None

    def results(self):
        if self._out is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=300)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    pytest.fail("gloo worker timed out")
            for rank, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0 and f"rank {rank} OK" in log, log[-3000:]
            self._out = [pickle.load(open(self.tmp / f"out{r}.pkl", "rb")) for r in range(2)]
        return self._out


@pytest.fixture(scope="module")
def models():
    jm = _jax_model()
    return jm, _state_dict(jm)


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_world")
    inputs = {"sd": models[1], "sp": _sp_inputs(), "train": _train_batch(),
              "sp_w": np.random.default_rng(5).normal(size=(2, NH, 64, HD)).astype(np.float32),
              "x": np.random.default_rng(3).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32),
              "amg_kw": AMG_KW, "amg_image": _amg_image(), "exp_dir": str(tmp / "runs")}
    return World(WORKER, inputs, tmp), inputs


# ---------------------------------------------------------------------------
# Layouts (one process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nh,hd,tp", [(4, 16, 2), (4, 16, 4), (16, 80, 2), (16, 80, 8), (12, 64, 1)])
def test_qkv_perm_bit_equal(nh, hd, tp):
    np.testing.assert_array_equal(tmesh._qkv_perm(nh, hd, tp), jmesh._qkv_perm(nh, hd, tp))


@pytest.mark.parametrize("kind", ["dense", "w4", "int8"])
def test_tp_pack_qkv_bit_equal(models, kind):
    """tp_pack_qkv on dense, W4 PackedLinear and IntLinear qkv layers gives
    JAX's permuted tensors bit for bit (dense in the port's (out, in) layout)."""
    jm, sd = models
    enc = _port_model(sd).image_encoder
    if kind != "dense":
        enc = tseq.rtn_quantize_encoder(enc, tseq.GPTQConfig(4, 32, sym=True))
    if kind == "int8":
        enc = tpacked.cache_int8(enc, skip=None)
    tree = dict(jm.image_encoder, blocks=[
        dict(b, attn=dict(b["attn"], qkv=b["attn"]["qkv"] if kind == "dense" else
                          _jax_layer(blk.attn.qkv)))
        for b, blk in zip(jm.image_encoder["blocks"], enc.blocks)])
    want = jmesh.tp_pack_qkv(tree, NH, 2)
    tmesh.tp_pack_qkv(enc, NH, 2)
    fields = {"dense": ("weight", "bias"), "w4": ("qweight", "scales", "zeros", "bias"),
              "int8": ("w8", "scales", "bias")}[kind]
    for i, blk in enumerate(enc.blocks):
        got, ref = blk.attn.qkv, want["blocks"][i]["attn"]["qkv"]
        for f in fields:
            g = getattr(got, f).numpy()
            r = np.asarray(ref[{"weight": "w", "bias": "b"}[f]] if kind == "dense"
                           else getattr(ref, f))
            np.testing.assert_array_equal(g.T if f == "weight" else g, r, err_msg=f)


# ---------------------------------------------------------------------------
# Two ranks against JAX
# ---------------------------------------------------------------------------


def test_world_ranks_and_loss_dict(world):
    out = world[0].results()
    assert [o["dp"] for o in out] == [(0, 0), (1, 1)]  # (dp index on 2x1, tp index on 1x2)
    for o in out:  # every rank gets the mean
        assert o["loss_dict"] == {"iou": 0.125, "loss": 1.5}


@pytest.mark.parametrize("rel", [True, False])
def test_sp_attention_grad_matches_jax(world, rel):
    """The two-rank sp_attention under autograd: every rank's gradients of
    sum(out * w) for q, k, v (and rel_h, rel_w) against
    sp_attention_reference's and against jax.grad of JAX's sp_attention on
    a tp 2 mesh, atol 1e-5."""
    (q, k, v), (rh, rw) = world[1]["sp"]
    w = world[1]["sp_w"]
    args = [q, k, v] + ([rh, rw] if rel else [])
    mesh = jmesh.make_mesh(2, tp=2)

    def jloss(*a):
        o = jsp.sp_attention(*a[:3], *(a[3:] if rel else (None, None)), HD**-0.5, mesh)
        return jnp.sum(o * jnp.asarray(w))

    want = [np.asarray(g) for g in jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ref_out = tsp.sp_attention_reference(*ins[:3], *(ins[3:] if rel else (None, None)),
                                         HD**-0.5)
    ref = torch.autograd.grad((ref_out * torch.from_numpy(w)).sum(), ins)
    for o in world[0].results():
        got = o["sp_grad_" + ("rel" if rel else "norel")]
        assert (got[3] is None) == (not rel)
        for g, wj, r in zip(got, want, ref):
            np.testing.assert_allclose(g, wj, atol=1e-5, rtol=0)
            np.testing.assert_allclose(g, r.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rel", [True, False])
def test_sp_attention_matches_jax(world, rel):
    """Two-rank sp_attention against JAX's sp_attention on a tp 2 mesh and
    against sp_attention_reference, within atol 1e-5."""
    (q, k, v), (rh, rw) = world[1]["sp"]
    rh, rw = (rh, rw) if rel else (None, None)
    mesh = jmesh.make_mesh(2, tp=2)
    want = np.asarray(jsp.sp_attention(*map(jnp.asarray, (q, k, v)),
                                       None if rh is None else jnp.asarray(rh),
                                       None if rw is None else jnp.asarray(rw), HD**-0.5, mesh))
    t = lambda a: None if a is None else torch.from_numpy(a)
    ref = tsp.sp_attention_reference(t(q), t(k), t(v), t(rh), t(rw), HD**-0.5).numpy()
    for o in world[0].results():
        got = o["sp_rel" if rel else "sp_norel"]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_tensor_parallel_encoder_matches_jax(models, world):
    """The two-rank encoder under tensor_parallel (tp 2, packed qkv) against
    JAX's encoder under tensor_parallel on make_mesh(4, tp=2), atol 1e-4;
    rank 0's qkv shard is JAX's packed layout's first half."""
    jm = models[0]
    x = world[1]["x"]
    ecfg = JCONFIGS["vit_tiny"].image_encoder
    mesh = jmesh.make_mesh(4, tp=2)
    packed = jmesh.tp_pack_qkv(jm.image_encoder, NH, 2)
    sharded = jmesh.shard_params(packed, mesh, jmesh.encoder_param_specs(packed))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp")))
    fn = jax.jit(lambda p, xi: jenc.apply(p, xi, ecfg, attn_impl="xla"))
    with jmesh.tensor_parallel(mesh):
        want = np.asarray(fn(sharded, xs))
    out = world[0].results()
    qkv0 = np.asarray(packed["blocks"][0]["attn"]["qkv"]["w"])
    np.testing.assert_array_equal(out[0]["qkv_shard"].T, qkv0[:, : 3 * NH * HD // 2])
    for o in out:
        np.testing.assert_allclose(o["tp_dense"], want, atol=1e-4, rtol=0)


def test_sequence_parallel_encoder_matches_jax(models, world):
    """The two-rank encoder under sequence_parallel(min_len=64) against JAX's
    sequence-parallel call site on a tp 2 mesh, atol 1e-4."""
    jm = models[0]
    x = jnp.asarray(world[1]["x"])
    ecfg = JCONFIGS["vit_tiny"].image_encoder
    with jsp.sequence_parallel(jmesh.make_mesh(2, tp=2), axis="tp", min_len=64):
        want = np.asarray(jenc.apply(jm.image_encoder, x, ecfg, attn_impl="xla"))
    for o in world[0].results():
        np.testing.assert_allclose(o["sp_encoder"], want, atol=1e-4, rtol=0)


def _jax_tp2(tree, x):
    """JAX's encoder ``tree`` (quantized block linears) under tensor_parallel
    on make_mesh(4, tp=2), x sharded over dp. ``encoder_param_specs`` writes
    a ``PackedLinear`` spec with the default ``act_bits`` and ``sym``, so
    the spec takes the layer's own to match its tree."""
    packed = jmesh.tp_pack_qkv(tree, NH, 2)
    specs = jmesh.encoder_param_specs(packed)
    for blk, spec in zip(packed["blocks"], specs["blocks"]):
        for part, names in (("attn", ("qkv", "proj")), ("mlp", ("lin1", "lin2"))):
            for n in names:
                if isinstance(blk[part][n], JPackedLinear):
                    spec[part][n] = dataclasses.replace(
                        spec[part][n], act_bits=blk[part][n].act_bits, sym=blk[part][n].sym)
    mesh = jmesh.make_mesh(4, tp=2)
    sharded = jmesh.shard_params(packed, mesh, specs)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp")))
    ecfg = JCONFIGS["vit_tiny"].image_encoder
    with jmesh.tensor_parallel(mesh):
        return np.asarray(jax.jit(lambda p, xi: jenc.apply(p, xi, ecfg, attn_impl="xla"))(
            sharded, xs))


def _jax_encoder_tree(jm, enc):
    """JAX's encoder pytree with the port encoder ``enc``'s block linears."""
    blocks = []
    for b, blk in zip(jm.image_encoder["blocks"], enc.blocks):
        blocks.append(dict(b, attn=dict(b["attn"], qkv=_jax_layer(blk.attn.qkv),
                                        proj=_jax_layer(blk.attn.proj)),
                           mlp=dict(b["mlp"], lin1=_jax_layer(blk.mlp.lin1),
                                    lin2=_jax_layer(blk.mlp.lin2))))
    return dict(jm.image_encoder, blocks=blocks)


# Per-token int8 row shards (W4A8 g32 and cached int8 with no act scales)
# at tp 2, rel. L2 of the embedding. Against tp 1 (INT8_TP_TOL): both take
# the same integers wherever their block inputs are equal, and proj's and
# lin2's partial sums change only the float order of the residual stream
# (measured 2e-7 to 3e-7; JAX's own tp 2 against its tp 1 the same). Against
# JAX's tp 2 (INT8_JAX_TOL): the unsharded encoders already differ, the
# port summing exact integer dots scaled per group where JAX's CPU path
# takes a float32 dot of dequantized weights; on this random model and
# input a value within rounding of an int8 rounding point then moves its
# product by one activation step, and the steps cascade (measured 5.6e-3
# W4A8, 2.0e-3 cached int8; on the trained checkpoint none moves,
# tests/test_torch_quant_a8.py). The tp 2 gap must be the unsharded gap to
# INT8_TP_TOL: sharding adds nothing on either side.
INT8_TP_TOL = 1e-5
INT8_JAX_TOL = 1e-2


@pytest.mark.parametrize("case", ["w4", "w4a8", "int8", "int8_g32"])
def test_w4_encoder_tp2_matches_tp1(models, world, case):
    """A W4 g32 encoder at tp 2 against the port's unsharded W4 encoder,
    atol 1e-4 (a row shard that cuts pack blocks is refused); and the
    per-token int8 encoders (W4A8, whose row shards quantize at the token
    amax all-reduced over the group, and cached int8 with no act scales)
    against tp 1 and JAX's tp 2 within INT8_TP_TOL."""
    jm, sd = models
    x = world[1]["x"]
    enc = tseq.rtn_quantize_encoder(_port_model(sd).image_encoder,
                                    tseq.GPTQConfig(4, 32, sym=case != "w4"))
    if case == "w4a8":
        enc = tpacked.with_act_bits(enc, 8)
    elif case.startswith("int8"):
        tpacked.cache_int8(enc, skip=None, per_channel=case == "int8")
    with torch.no_grad():
        want = enc(torch.from_numpy(x), "eager").numpy()
    out = world[0].results()
    if case == "w4":
        for o in out:
            np.testing.assert_allclose(o["tp_w4"], want, atol=1e-4, rtol=0)
            assert len(o["refused"]) == 1 and "pack blocks of 64" in o["refused"][0]
        return
    tree = _jax_encoder_tree(jm, enc)
    ecfg = JCONFIGS["vit_tiny"].image_encoder
    jax_tp1 = np.asarray(jax.jit(lambda p, xi: jenc.apply(p, xi, ecfg, attn_impl="xla"))(
        tree, jnp.asarray(x)))
    jax_tp2 = _jax_tp2(tree, x)
    assert _rel(jax_tp2, jax_tp1) <= INT8_TP_TOL
    unsharded = _rel(want, jax_tp1)
    for o in out:
        got = o["tp_" + case]
        assert np.isfinite(got).all()
        gap_tp1, gap_jax = _rel(got, want), _rel(got, jax_tp2)
        print(f"{case}: tp 2 vs tp 1 {gap_tp1:.2e}; vs JAX tp 2 {gap_jax:.2e} "
              f"(unsharded port vs JAX {unsharded:.2e})")
        assert gap_tp1 <= INT8_TP_TOL, gap_tp1
        assert gap_jax <= INT8_JAX_TOL and abs(gap_jax - unsharded) <= INT8_TP_TOL, gap_jax


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _one_process_step(sd, batch):
    images, gts, coords, labels = map(torch.from_numpy, batch)
    m = _port_model(sd)
    tcfg = ttrainer.TrainConfig(**TCFG)
    opt = ttrainer.make_optimizer(tcfg, m)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    aux = ttrainer.make_train_step(tcfg, opt)(m, images, gts, torch.Generator(),
                                              clicks=(coords, labels))
    after = {n: p.detach().numpy() for n, p in m.named_parameters()}
    mu = opt.state[m.image_encoder.blocks[0].attn.qkv.weight]["exp_avg"].numpy()
    return float(aux["loss"]), before, after, mu


@pytest.mark.parametrize("name", ["dp2", "tp2"])
def test_parallel_step_matches_one_process(models, world, name):
    """One dp 2 step and one dp 1 x tp 2 step, clicks given, against the
    one-process step on the full batch, on every rank: the parameters after
    the step within rel 1e-6 (L2 over all of them), AdamW's first moment of
    qkv within rel 1e-5 (L2); the tp ranks' losses equal the full batch's, the
    dp ranks' average to it (rel 1e-5). The two sides sum the batch's
    gradient in other orders, so they agree to float32 rounding; AdamW's
    first update, lr * g / (|g| + eps), is about lr wherever |g| >> eps, so
    a leaf whose exact gradient is zero (a key bias) moves by float32 noise
    on either side: no value may differ by more than 2 lr."""
    loss, before, after, mu = _one_process_step(models[1], world[1]["train"])
    out = world[0].results()
    losses = [o[name + "_loss"] for o in out]
    if name == "tp2":
        np.testing.assert_allclose(losses, [loss, loss], rtol=1e-5)
    else:
        np.testing.assert_allclose(np.mean(losses), loss, rtol=1e-5)
    for o in out:
        got = o[name]
        assert got.keys() == after.keys()
        moved, d2, r2 = 0, 0.0, 0.0
        for n, ref in after.items():
            d2 += float(np.sum((got[n].astype(np.float64) - ref) ** 2))
            r2 += float(np.sum(ref.astype(np.float64) ** 2))
            moved += bool(np.any(ref != before[n].numpy()))
            assert np.abs(got[n] - ref).max() <= 2 * ttrainer.TrainConfig().learning_rate, n
        assert np.sqrt(d2 / r2) <= 1e-6, np.sqrt(d2 / r2)
        assert moved > 0.8 * len(after), moved
        mu_gap = np.linalg.norm(o[name + "_qkv_mu"] - mu) / np.linalg.norm(mu)
        assert mu_gap <= 1e-5, mu_gap
        print(f"{name}: params rel L2 {np.sqrt(d2 / r2):.2e}, qkv first moment {mu_gap:.2e}")


def test_train_cli_tp2_checkpoint_resumes_in_one_process(world):
    """``cli.train vit_tiny --tp 2`` in the two-rank gloo world takes two
    steps and writes the full model, which a one-process ``--resume`` reads."""
    out = world[0].results()
    assert [o["cli"] for o in out] == [0, 0]
    exp_dir = pathlib.Path(world[1]["exp_dir"])
    run = exp_dir / "000-finetune"
    ckpt = run / "checkpoints"
    assert json.loads((ckpt / "sam_model_latest.json").read_text())["epoch"] == 1
    first = dict(np.load(ckpt / "sam_model_latest.npz"))
    assert int(first["o0"]) == 2
    base = ["vit_tiny", "--platform", "cpu", "--exp-dir", str(exp_dir), "--steps-per-epoch",
            "2", "--num-clicks", "2", "--seed", "3"]
    assert tcli.main(base + ["--resume", "000", "--epochs", "2"]) == 0
    second = dict(np.load(ckpt / "sam_model_latest.npz"))
    assert int(second["o0"]) == 4 and list(second) == list(first)
    assert all(second[k].shape == first[k].shape for k in first)


def test_reduce_loss_dict_in_a_world_of_one():
    assert tdist.reduce_loss_dict({"loss": 2.5}) == {"loss": 2.5}
    assert tdist.get_world_size() == 1 and tdist.is_main_process()


# ---------------------------------------------------------------------------
# AMG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag,kw", [("packed", {}), ("crops", {"crop_n_layers": 1})])
def test_mesh_amg_matches_meshless(models, world, tag, kw):
    """The two-rank mesh AMG (dp 2) returns the meshless port's annotations
    on every rank (the meshless port holds JAX's golden)."""
    ref = TGenerator(_port_model(models[1]), **AMG_KW, **kw).generate(_amg_image())
    for o in world[0].results():
        gaps = tamg.annotation_gaps(ref, o["amg_" + tag])
        assert gaps["ref"] == gaps["got"] == gaps["matched"] > 0, gaps
        for key, tol in AMG_TOL.items():
            assert gaps[key] <= tol, (key, gaps)
