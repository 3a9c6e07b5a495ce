"""The port's export tail on the CPU, held against the JAX package.

ONNX (``export_onnx``): the port's decoder and encoder artifacts are byte-
equal to JAX's for the same weights and producer string; the port's wire
codec writes what ``google.protobuf`` writes for the same messages, its
field table agrees with the committed ``onnx_descriptor.binpb`` and it
parses both packages' bytes back to the same bytes; the port's numpy
runtime equals JAX's bit for bit on JAX's bytes and reproduces JAX's
decoder and encoder at JAX's own tolerances (``tests/test_onnx_export.py``:
masks and low-res 1e-4, IoU 1e-5, encoder 5e-5). ``torch.export``
(``export``): ``SamDecoderModule``, the saved and loaded decoder and
encoder programs against the module and JAX (1e-4, JAX's
``test_export_decoder_roundtrip``). ``sam.forward`` against JAX's
``forward`` (1e-4). ``cli.export``, ``utils/vis``, ``Profiler`` and
``TqdmToLogger`` against their JAX counterparts, and ``cli.train
--sbd-dir``. The AOTInductor packages and ``csrc/aoti_runner.cpp`` are
``tests/test_torch_export_aoti.py``. Weights are drawn by JAX from a seed
(rel-pos tables drawn with numpy, so the bias contributes) and carried
across with ``build_sam.from_jax_params``.
"""

import contextlib
import io
import json
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu import export as jexport
from sam_quantization_tpu import export_onnx as jonnx
from sam_quantization_tpu.export_onnx import _proto as JP
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.utils import experiment as jexp
from sam_quantization_tpu.utils import vis as jvis
from sam_quantization_tpu_torch import export as texport
from sam_quantization_tpu_torch import export_onnx as tonnx
from sam_quantization_tpu_torch.cli import export as export_cli
from sam_quantization_tpu_torch.cli import train as train_cli
from sam_quantization_tpu_torch.export_onnx import _wire
from sam_quantization_tpu_torch.export_onnx import builder, encoder_graph
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.quant import sequential as tseq
from sam_quantization_tpu_torch.utils import experiment as texp
from sam_quantization_tpu_torch.utils import vis as tvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PRODUCER = "sam_quantization_tpu"
NUM_POINTS = 4
# tests/test_onnx_export.py's allowed op set (opset-11 core domain)
ALLOWED_OPS = {
    "MatMul", "Add", "Sub", "Mul", "Div", "Sqrt", "Erf", "Sin", "Cos",
    "Relu", "Sigmoid", "Max", "Equal", "Greater", "Where", "Cast",
    "Softmax", "Transpose", "Reshape", "Concat", "Slice", "Gather",
    "Unsqueeze", "ReduceMean", "ReduceSum", "ArgMax", "Expand", "Conv",
    "ConvTranspose", "Resize",
}
DECODER_TOL = {"masks": 1e-4, "iou_predictions": 1e-5, "low_res_masks": 1e-4}


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jmodel():
    """vit_tiny from PRNGKey(0), rel-pos tables drawn from numpy seed 5."""
    jm = jsam.init(jax.random.PRNGKey(0), JCONFIGS["vit_tiny"])
    enc = _to_np(jm.image_encoder)
    r = np.random.default_rng(5)
    for blk in enc["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][k] = (r.standard_normal(blk["attn"][k].shape) * 0.2).astype(np.float32)
    return jsam.Sam(jax.tree_util.tree_map(jnp.asarray, enc), jm.prompt_encoder,
                    jm.mask_decoder, JCONFIGS["vit_tiny"])


@pytest.fixture(scope="module")
def tmodel(jmodel):
    sd = tbuild.from_jax_params(_to_np(jmodel.image_encoder), _to_np(jmodel.prompt_encoder),
                                _to_np(jmodel.mask_decoder), TCONFIGS["vit_tiny"])
    return tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)


@pytest.fixture(scope="module")
def prompts():
    """tests/test_onnx_export.py's prompts (NHWC embedding and mask)."""
    cfg = JCONFIGS["vit_tiny"].prompt_encoder
    h, w = cfg.image_embedding_size
    rng = np.random.default_rng(7)
    return {
        "emb": (rng.normal(size=(1, h, w, cfg.embed_dim)) * 0.5).astype(np.float32),
        "coords": rng.uniform(10, cfg.input_image_size[0] - 10,
                              size=(1, NUM_POINTS, 2)).astype(np.float32),
        "labels": np.array([[1, 0, 1, -1]], np.float32),
        "mask": (rng.normal(size=(1, 4 * h, 4 * w, 1)) * 2).astype(np.float32),
    }


def _onnx_feeds(prompts, has_mask):
    return {
        "image_embeddings": prompts["emb"].transpose(0, 3, 1, 2),
        "point_coords": prompts["coords"],
        "point_labels": prompts["labels"],
        "mask_input": prompts["mask"].transpose(0, 3, 1, 2),
        "has_mask_input": np.full((1,), has_mask, np.float32),
    }


def _module_args(prompts, has_mask):
    return (prompts["emb"], prompts["coords"], prompts["labels"], prompts["mask"],
            np.full((1,), has_mask, np.float32))


def _jax_decoder(jmodel, prompts, has_mask, **kw):
    mod = jexport.SamDecoderModule(jmodel, **kw)
    out = mod(*map(jnp.asarray, _module_args(prompts, has_mask)))
    return dict(zip(texport.DECODER_OUTPUTS, (np.asarray(o, np.float32) for o in out)))


def _port_decoder(module, prompts, has_mask):
    with torch.no_grad():
        out = module(*map(torch.from_numpy, _module_args(prompts, has_mask)))
    return dict(zip(texport.DECODER_OUTPUTS, (o.float().numpy() for o in out)))


def _assert_decoder_close(got, want, tol=None):
    for k in texport.DECODER_OUTPUTS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=(tol or DECODER_TOL)[k], err_msg=k)


def _image(seed, size=128):
    return np.random.default_rng(seed).normal(size=(1, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# ONNX bytes
# ---------------------------------------------------------------------------

DECODER_VARIANTS = {
    "p4_single": dict(num_points=4),
    "p8_single": dict(num_points=8),
    "p4_all": dict(num_points=4, return_single_mask=False),
    "p8_all": dict(num_points=8, return_single_mask=False),
    "p4_stability": dict(num_points=4, use_stability_score=True, stability_score_offset=0.5),
}


@pytest.mark.parametrize("variant", list(DECODER_VARIANTS))
def test_decoder_onnx_bytes_equal_jax(jmodel, tmodel, variant):
    kw = DECODER_VARIANTS[variant]
    want = jonnx.export_decoder_onnx(jmodel, **kw)
    assert tonnx.export_decoder_onnx(tmodel, producer=JAX_PRODUCER, **kw) == want
    own = tonnx.export_decoder_onnx(tmodel, **kw)
    assert _wire.parse("ModelProto", own).producer_name == "sam_quantization_tpu_torch"


def test_encoder_onnx_bytes_equal_jax(jmodel, tmodel, tmp_path):
    want = jonnx.export_encoder_onnx(jmodel)
    path = tmp_path / "encoder.onnx"
    assert tonnx.export_encoder_onnx(tmodel, str(path), producer=JAX_PRODUCER) == want
    assert path.read_bytes() == want


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("part", ["decoder", "encoder"])
def test_parser_round_trips_bytes(jmodel, tmodel, writer, part):
    """Parse, then write again: the same bytes, for the port's own artifact
    and for JAX's (written by google.protobuf)."""
    if part == "decoder":
        blob = (tonnx.export_decoder_onnx(tmodel, num_points=NUM_POINTS) if writer == "port"
                else jonnx.export_decoder_onnx(jmodel, num_points=NUM_POINTS))
    else:
        blob = (tonnx.export_encoder_onnx(tmodel) if writer == "port"
                else jonnx.export_encoder_onnx(jmodel))
    m = _wire.parse("ModelProto", blob)
    assert _wire.serialize(m) == blob
    ref = JP.ModelProto()
    ref.ParseFromString(blob)
    assert [n.op_type for n in m.graph.node] == [n.op_type for n in ref.graph.node]
    assert [t.name for t in m.graph.initializer] == [t.name for t in ref.graph.initializer]


def _jp_attr(name, type_, **kw):
    a = JP.AttributeProto()
    a.name, a.type = name, type_
    for k, v in kw.items():
        if isinstance(v, list):
            getattr(a, k).extend(v)
        else:
            setattr(a, k, v)
    return a


def _jp_tensor(**kw):
    t = JP.TensorProto()
    for k, v in kw.items():
        if isinstance(v, list):
            getattr(t, k).extend(v)
        else:
            setattr(t, k, v)
    return t


def _jp_opset():
    op = JP.OperatorSetIdProto()
    op.domain, op.version = "", 11
    return op


# (google.protobuf message, the port's Message): negative int64s as 10-byte
# varints (attribute i and unpacked ints, packed int64_data), fixed32 floats
# (f, unpacked floats, packed float_data), proto2 presence (an empty domain,
# i = 0, empty raw_data), unpacked dims.
WIRE_CASES = {
    "ints_negative": lambda: (
        _jp_attr("axes", JP.AttributeProto.INTS, ints=[-1, 0, 3]),
        _wire.Message("AttributeProto", name="axes", type=_wire.ATTR_INTS, ints=[-1, 0, 3])),
    "i_zero": lambda: (
        _jp_attr("keepdims", JP.AttributeProto.INT, i=0),
        _wire.Message("AttributeProto", name="keepdims", type=_wire.ATTR_INT, i=0)),
    "i_negative": lambda: (
        _jp_attr("axis", JP.AttributeProto.INT, i=-2),
        _wire.Message("AttributeProto", name="axis", type=_wire.ATTR_INT, i=-2)),
    "floats": lambda: (
        _jp_attr("scales", JP.AttributeProto.FLOATS, floats=[0.5, -2.25], f=0.0),
        _wire.Message("AttributeProto", name="scales", type=_wire.ATTR_FLOATS, f=0.0,
                      floats=[0.5, -2.25])),
    "opset_empty_domain": lambda: (
        _jp_opset(), _wire.Message("OperatorSetIdProto", domain="", version=11)),
    "tensor_empty_raw": lambda: (
        _jp_tensor(dims=[0], data_type=JP.FLOAT, name="roi", raw_data=b""),
        _wire.Message("TensorProto", dims=[0], data_type=_wire.FLOAT, name="roi",
                      raw_data=b"")),
    "tensor_packed": lambda: (
        _jp_tensor(dims=[2, 3], data_type=JP.INT64, int64_data=[-5, 7, 2**40],
                   float_data=[1.5, -0.0], name="t"),
        _wire.Message("TensorProto", dims=[2, 3], data_type=_wire.INT64,
                      int64_data=[-5, 7, 2**40], float_data=[1.5, -0.0], name="t")),
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_wire_codec_matches_protobuf(case):
    ref, msg = WIRE_CASES[case]()
    blob = ref.SerializeToString()
    assert _wire.serialize(msg) == blob
    assert _wire.parse(msg.type_name, blob) == msg


def test_wire_reader_takes_packed_and_unpacked_dims():
    packed = b"\x0a\x03\x02\x03\x04"  # dims (1, LEN) packed: 2, 3, 4
    unpacked = b"\x08\x02\x08\x03\x08\x04"
    for blob in (packed, unpacked):
        assert _wire.parse("TensorProto", blob).dims == [2, 3, 4]
    assert _wire.serialize(_wire.parse("TensorProto", packed)) == unpacked


_DESCRIPTOR_TYPES = {3: "int64", 5: "int32", 14: "int32", 2: "float", 1: "double",
                     9: "string", 12: "bytes"}  # FieldDescriptorProto.Type -> kind


def test_field_table_matches_descriptor():
    """Every field of the port's table has the committed schema's name,
    number, type (an enum is an int32 on the wire), label and packing."""
    from google.protobuf import descriptor_pb2

    fds = descriptor_pb2.FileDescriptorSet()
    with open(os.path.join(ROOT, "sam_quantization_tpu", "export_onnx",
                           "onnx_descriptor.binpb"), "rb") as f:
        fds.ParseFromString(f.read())
    messages = {}

    def walk(m, prefix):
        messages[prefix + m.name] = m
        for n in m.nested_type:
            walk(n, prefix + m.name + ".")

    for m in fds.file[0].message_type:
        walk(m, "")
    for type_name, fields in _wire.SCHEMA.items():
        desc = {f.name: f for f in messages[type_name].field}
        for name, f in fields.items():
            d = desc[name]
            assert d.number == f.number, (type_name, name)
            kind = (d.type_name.removeprefix(".onnx.") if d.type == d.TYPE_MESSAGE
                    else _DESCRIPTOR_TYPES[d.type])
            assert kind == f.kind, (type_name, name)
            assert (d.label == d.LABEL_REPEATED) == f.repeated, (type_name, name)
            assert d.options.packed == f.packed, (type_name, name)


# ---------------------------------------------------------------------------
# The 2 GiB limit
# ---------------------------------------------------------------------------


def _shape_only_encoder_graph(name, monkeypatch):
    """build_encoder_graph on ``name``'s encoder built on the meta device:
    every weight a zero-strided view of its shape, and the initializers'
    protos left empty, so no weight is held in memory."""
    monkeypatch.setattr(tbuild, "_np", lambda t, perm=None: np.broadcast_to(
        np.float32(0), t.shape if perm is None else [t.shape[i] for i in perm]))
    monkeypatch.setattr(builder, "tensor_proto", lambda name, arr: None)
    return encoder_graph.build_encoder_graph(tsam.Sam(TCONFIGS[name], device="meta"))


def test_encoder_size_reckoning_from_config(monkeypatch):
    """ViT-H's float32 encoder cannot be one ModelProto: the builder's count
    of its initializers refuses it at its config's shapes, with no weight
    built; ViT-L and ViT-B fit."""
    with pytest.raises(ValueError, match="2 GiB"):
        _shape_only_encoder_graph("vit_h", monkeypatch)
    sizes = {name: _shape_only_encoder_graph(name, monkeypatch).nbytes
             for name in ("vit_l", "vit_b")}
    assert 1.1e9 < sizes["vit_l"] < 1.3e9 and sizes["vit_b"] == 369974780


def test_builder_counts_the_initializer_bytes(tmodel):
    """The builder's count is the bytes of the initializers it writes."""
    g = encoder_graph.build_encoder_graph(tmodel)
    m = _wire.parse("ModelProto", _wire.serialize(g.build_model(tonnx.OPSET)))
    assert g.nbytes == sum(len(t.raw_data) for t in m.graph.initializer) > 0


def test_size_limit_raises_before_writing(tmodel, monkeypatch, tmp_path):
    monkeypatch.setattr(builder, "MAX_MESSAGE_BYTES", 1000)
    with pytest.raises(ValueError, match="2 GiB"):
        tonnx.export_encoder_onnx(tmodel, str(tmp_path / "enc.onnx"))
    with pytest.raises(ValueError, match="2 GiB"):
        tonnx.export_decoder_onnx(tmodel, str(tmp_path / "dec.onnx"), num_points=NUM_POINTS)
    monkeypatch.setattr(builder, "MAX_MESSAGE_BYTES", 2**31 - 1)
    monkeypatch.setattr(_wire, "MAX_MESSAGE_BYTES", 1000)
    with pytest.raises(ValueError, match="past protobuf's limit"):
        tonnx.export_decoder_onnx(tmodel, str(tmp_path / "dec.onnx"), num_points=NUM_POINTS)
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# ONNX runtime and numerics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("has_mask", [1.0, 0.0])
def test_runtime_on_jax_bytes_equals_jax_runtime(jmodel, prompts, has_mask):
    blob = jonnx.export_decoder_onnx(jmodel, num_points=NUM_POINTS)
    feeds = _onnx_feeds(prompts, has_mask)
    want = jonnx.runtime.load(blob).run(feeds)
    got = tonnx.runtime.load(blob).run(feeds)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_encoder_runtime_on_jax_bytes_equals_jax_runtime(jmodel):
    blob = jonnx.export_encoder_onnx(jmodel)
    feeds = {"input": _image(11).transpose(0, 3, 1, 2)}
    want = jonnx.runtime.load(blob).run(feeds)["image_embeddings"]
    assert np.array_equal(tonnx.runtime.load(blob).run(feeds)["image_embeddings"], want)


@pytest.mark.parametrize("has_mask", [1.0, 0.0])
def test_onnx_decoder_parity(jmodel, tmodel, prompts, has_mask):
    """The port's runtime on the port's bytes against JAX's
    SamDecoderModule, both mask-gate branches."""
    rt = tonnx.runtime.load(tonnx.export_decoder_onnx(tmodel, num_points=NUM_POINTS))
    _assert_decoder_close(rt.run(_onnx_feeds(prompts, has_mask)),
                          _jax_decoder(jmodel, prompts, has_mask))


@pytest.mark.parametrize("variant", ["p4_all", "p4_stability"])
def test_onnx_decoder_variants(jmodel, tmodel, prompts, variant):
    kw = DECODER_VARIANTS[variant]
    rt = tonnx.runtime.load(tonnx.export_decoder_onnx(tmodel, **kw))
    got = rt.run(_onnx_feeds(prompts, 1.0))
    want = _jax_decoder(jmodel, prompts, 1.0,
                        **{k: v for k, v in kw.items() if k != "num_points"})
    _assert_decoder_close(got, want)
    n = 1 if kw.get("return_single_mask", True) else JCONFIGS["vit_tiny"].mask_decoder.num_multimask_outputs
    assert got["masks"].shape[1] == n


def test_onnx_encoder_parity(jmodel, tmodel):
    rt = tonnx.runtime.load(tonnx.export_encoder_onnx(tmodel))
    x = _image(11)
    out = rt.run({"input": x.transpose(0, 3, 1, 2)})["image_embeddings"]
    ref = np.asarray(jsam.encode_image(jmodel, jnp.asarray(x))).transpose(0, 3, 1, 2)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=5e-5)
    assert out.shape[1] == TCONFIGS["vit_tiny"].prompt_encoder.embed_dim


def test_onnx_model_structure(tmodel):
    """IR 7, opset 11, I/O names and shapes, the allowed op set, and the
    checker accepting the graph and rejecting a broken one."""
    m = _wire.parse("ModelProto", tonnx.export_decoder_onnx(tmodel, num_points=8))
    assert m.ir_version == 7 == _wire.IR_VERSION
    assert m.opset_import[0].domain == "" and m.opset_import[0].version == 11
    ins = {vi.name: [d.dim_value for d in vi.type.tensor_type.shape.dim]
           for vi in m.graph.input}
    cfg = TCONFIGS["vit_tiny"]
    d = cfg.prompt_encoder.embed_dim
    h, w = cfg.prompt_encoder.image_embedding_size
    assert ins == {"image_embeddings": [1, d, h, w], "point_coords": [1, 8, 2],
                   "point_labels": [1, 8], "mask_input": [1, 1, 4 * h, 4 * w],
                   "has_mask_input": [1]}
    assert [vi.name for vi in m.graph.output] == ["masks", "iou_predictions", "low_res_masks"]
    assert {n.op_type for n in m.graph.node} <= ALLOWED_OPS
    tonnx.runtime.check_model(m)
    m.graph.node[0].input[0] = "no_such_tensor"
    with pytest.raises(ValueError, match="undefined tensor"):
        tonnx.runtime.check_model(m)

    e = _wire.parse("ModelProto", tonnx.export_encoder_onnx(tmodel))
    S, G = cfg.image_encoder.img_size, cfg.image_encoder.grid_size
    assert [(vi.name, [x.dim_value for x in vi.type.tensor_type.shape.dim])
            for vi in e.graph.input] == [("input", [1, 3, S, S])]
    assert [(vi.name, [x.dim_value for x in vi.type.tensor_type.shape.dim])
            for vi in e.graph.output] == [("image_embeddings",
                                           [1, cfg.image_encoder.out_chans, G, G])]
    assert {n.op_type for n in e.graph.node} <= ALLOWED_OPS
    tonnx.runtime.check_model(e)
    e.graph.node[1].output[0] = e.graph.node[0].output[0]
    with pytest.raises(ValueError, match="defined twice"):
        tonnx.runtime.check_model(e)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("part", ["decoder", "encoder"])
def test_export_cli_onnx(tmp_path, capsys, part):
    out = tmp_path / f"{part}.onnx"
    rc = export_cli.main(["vit_tiny", "--format", "onnx", "--part", part, "--output",
                          str(out), "--num-points", "2", "--platform", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line == {"format": "onnx", "part": part, "output": str(out),
                    "bytes": out.stat().st_size, "opset": 11}
    model = tbuild.sam_model_registry["vit_tiny"](device="cpu", seed=0)
    want = (tonnx.export_decoder_onnx(model, num_points=2) if part == "decoder"
            else tonnx.export_encoder_onnx(model))
    assert out.read_bytes() == want
    rt = tonnx.runtime.load(str(out))
    assert rt.input_names[0] == ("image_embeddings" if part == "decoder" else "input")


def test_export_cli_pt2_and_jax_format_names(tmp_path, capsys):
    out = tmp_path / "decoder.pt2"
    assert export_cli.main(["vit_tiny", "--format", "export", "--output", str(out),
                            "--num-points", "2", "--return-all-masks", "--platform", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"format": "export", "part": "decoder", "output": str(out),
                    "bytes": out.stat().st_size}
    fn = texport.load_exported(str(out))
    cfg = TCONFIGS["vit_tiny"].prompt_encoder
    h, w = cfg.image_embedding_size
    masks, iou, low = fn(torch.zeros(1, h, w, cfg.embed_dim), torch.zeros(1, 2, 2),
                         torch.ones(1, 2), torch.zeros(1, 4 * h, 4 * w, 1), torch.zeros(1))
    assert masks.shape == (1, 3, 128, 128) and iou.shape == (1, 3) and low.shape[-1] == 4 * w
    for jax_name, ours in (("stablehlo", "export"), ("savedmodel", "aoti")):
        with pytest.raises(SystemExit):
            export_cli.main(["vit_tiny", "--format", jax_name, "--output", str(out),
                             "--platform", "cpu"])
        assert f"--format {ours}" in capsys.readouterr().err


def test_export_cli_aoti_takes_return_all_masks(tmp_path, capsys, monkeypatch):
    """``--format aoti --return-all-masks`` compiles the all-masks program
    (the compile is replaced by a record of the program's outputs). JAX's
    ``--format savedmodel`` accepts the flag and drops it:
    ``export_decoder_savedmodel`` takes no such argument (ROADMAP Queue 3)."""
    import inspect

    import torch._inductor

    seen = []
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package", lambda program, **kw:
                        seen.append([tuple(n.meta["val"].shape) for n in
                                     program.graph.find_nodes(op="output")[0].args[0]]))
    out = tmp_path / "dec_aoti"
    assert export_cli.main(["vit_tiny", "--format", "aoti", "--output", str(out), "--num-points",
                            "2", "--return-all-masks", "--platform", "cpu"]) == 0
    assert seen == [[(1, 3, 128, 128), (1, 3), (1, 3, 32, 32)]]
    assert (out / "manifest.txt").read_text().splitlines()[-3:] == [
        "out masks 0", "out iou_predictions 1", "out low_res_masks 2"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["format"] == "aoti"
    assert "return_single_mask" not in inspect.signature(
        jexport.export_decoder_savedmodel).parameters


# ---------------------------------------------------------------------------
# SamDecoderModule, torch.export programs, sam.forward
# ---------------------------------------------------------------------------

MODULE_VARIANTS = {
    "single": {}, "all": dict(return_single_mask=False),
    "stability": dict(use_stability_score=True, stability_score_offset=0.5),
}


@pytest.mark.parametrize("has_mask", [1.0, 0.0])
@pytest.mark.parametrize("variant", list(MODULE_VARIANTS))
def test_decoder_module_matches_jax(jmodel, tmodel, prompts, variant, has_mask):
    kw = MODULE_VARIANTS[variant]
    got = _port_decoder(texport.SamDecoderModule(tmodel, **kw), prompts, has_mask)
    want = _jax_decoder(jmodel, prompts, has_mask, **kw)
    _assert_decoder_close(got, want, {k: 1e-4 for k in texport.DECODER_OUTPUTS})


def test_export_decoder_roundtrip(jmodel, tmodel, prompts, tmp_path):
    """Saved, loaded and run: equal to the module it was exported from, and
    within 1e-4 of JAX's (JAX's test_export_decoder_roundtrip tolerance)."""
    path = str(tmp_path / "decoder.pt2")
    program = texport.export_decoder(tmodel, path, num_points=NUM_POINTS)
    assert [s.arg.name for s in program.graph_signature.input_specs
            if s.kind.name == "USER_INPUT"] == list(texport.DECODER_INPUTS)
    assert not any("image_encoder" in k for k in program.state_dict)
    fn = texport.load_exported(path)
    for has_mask in (1.0, 0.0):
        with torch.no_grad():
            out = fn(*map(torch.from_numpy, _module_args(prompts, has_mask)))
        got = dict(zip(texport.DECODER_OUTPUTS, (o.numpy() for o in out)))
        module = _port_decoder(texport.SamDecoderModule(tmodel), prompts, has_mask)
        want = _jax_decoder(jmodel, prompts, has_mask)
        for k in texport.DECODER_OUTPUTS:
            np.testing.assert_allclose(got[k], module[k], rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_export_encoder_roundtrip(jmodel, tmodel, tmp_path):
    path = str(tmp_path / "encoder.pt2")
    texport.export_encoder(tmodel, path)
    x = _image(12)
    with torch.no_grad():
        got = texport.load_exported(path)(torch.from_numpy(x)).numpy()
        eager = tsam.encode_image(tmodel, torch.from_numpy(x), "eager").numpy()
    want = np.asarray(jsam.encode_image(jmodel, jnp.asarray(x), attn_impl="xla"))
    np.testing.assert_allclose(got, eager, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _w4_tiny(seed=3):
    m = tbuild.sam_model_registry["vit_tiny"](device="cpu", seed=seed)
    tseq.rtn_quantize_encoder(m.image_encoder, tseq.GPTQConfig(bits=4, groupsize=32))
    return m


def test_kernel_ops_export_records_and_aoti_refuses(tmp_path):
    """The custom ops a packed layer exports as on the card: torch.export
    records them with their output shapes and dtypes, a saved program loads
    with them, and the AOTInductor packager refuses them by name before it
    writes anything. (Their CUDA implementation, the kernel launch, runs in
    tests/test_torch_kernels_gpu.py.)"""
    p = _w4_tiny().image_encoder.blocks[0].attn.qkv

    class Calls(torch.nn.Module):
        def forward(self, x, xq, xs):
            return (tqm.quant_matmul_op(x, p.qweight, None, p.scales, p.zeros, p.bits,
                                        p.groupsize, p.pack_block, p.out_features),
                    tqm.a8_matmul_op(xq, xs, p.qweight, p.scales, p.zeros, p.bits, p.groupsize,
                                     p.pack_block, p.out_features, False, torch.bfloat16))

    M, K = 5, p.in_features
    program = torch.export.export(Calls(), (torch.zeros(M, K), torch.zeros(M, K, dtype=torch.int8),
                                            torch.ones(M, 1)))
    torch.export.save(program, str(tmp_path / "ops.pt2"))
    loaded = torch.export.load(str(tmp_path / "ops.pt2"))
    assert texport.kernel_ops_held(loaded) == list(tqm.KERNEL_OPS)
    out = [n for n in loaded.graph.nodes if n.op == "output"][0].args[0]
    assert [(tuple(o.meta["val"].shape), o.meta["val"].dtype) for o in out] == [
        ((M, p.out_features), torch.float32), ((M, p.out_features), torch.bfloat16)]
    with pytest.raises(ValueError, match="a8_matmul, sam_quantization_tpu_torch::quant_matmul"):
        texport._aoti_package(loaded, str(tmp_path / "pkg"), ("x",), ("y",))
    assert not (tmp_path / "pkg").exists()


def test_cpu_w4_export_holds_plain_dequant(tmp_path):
    """On the CPU a packed layer exports as its plain dequant-matmul (JAX's
    exports off the TPU hold quant_matmul_xla): no kernel op, and the
    program computes what the eager W4 encoder computes."""
    m = _w4_tiny()
    program = texport.export_encoder(m, str(tmp_path / "w4.pt2"))
    assert texport.kernel_ops_held(program) == []
    x = torch.from_numpy(_image(13))
    with torch.no_grad():
        got = texport.load_exported(str(tmp_path / "w4.pt2"))(x)
        want = tsam.encode_image(m, x, "eager")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("multimask", [False, True])
def test_sam_forward_matches_jax(jmodel, tmodel, multimask):
    """B = 2 raw images of 120 x 100 (padded by preprocess), two clicks
    each, through the port's default kernel path (the plain versions on the
    CPU) against JAX's forward."""
    r = np.random.default_rng(9)
    images = r.integers(0, 256, (2, 120, 100, 3)).astype(np.float32)
    coords = r.uniform(5, 95, (2, 2, 2)).astype(np.float32)
    labels = np.array([[1, 0], [1, 1]], np.float32)
    want = jsam.forward(jmodel, jnp.asarray(images), jnp.asarray(coords), jnp.asarray(labels),
                        multimask_output=multimask)
    with torch.no_grad():
        got = tsam.forward(tmodel, torch.from_numpy(images), torch.from_numpy(coords),
                           torch.from_numpy(labels), multimask_output=multimask)
    k = 3 if multimask else 1
    for g, w, shape in zip(got, want, ((2, k, 128, 128), (2, k), (2, k, 32, 32))):
        assert g.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


# ---------------------------------------------------------------------------
# vis, Profiler, TqdmToLogger, --sbd-dir
# ---------------------------------------------------------------------------


def test_vis_overlays_equal_jax():
    r = np.random.default_rng(3)
    image = r.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    mask = r.random((40, 50)) > 0.6
    coords = np.array([[10.0, 12.0], [30.5, 20.0], [5.0, 35.0]], np.float32)
    labels = np.array([1, 0, -1])
    box = np.array([3, 4, 41, 33])
    cases = [
        (jvis.blend_mask, tvis.blend_mask, (image, mask), {"alpha": 0.35}),
        (jvis.draw_points, tvis.draw_points, (image, coords, labels), {"radius": 3}),
        (jvis.draw_box, tvis.draw_box, (image, box), {"thickness": 3}),
    ]
    for jfn, tfn, args, kw in cases:
        want = jfn(*args, **kw)
        for conv in (lambda a: a, torch.from_numpy):
            got = tfn(*map(conv, args), **kw)
            assert got.dtype == want.dtype and np.array_equal(got, want), tfn.__name__


def test_vis_show_on_agg_figure():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    try:
        mask = torch.zeros(20, 30, dtype=torch.bool)
        mask[5:10, 5:15] = True
        tvis.show_mask(mask, ax)
        tvis.show_mask(mask.numpy(), ax, random_color=True)
        tvis.show_points(torch.tensor([[3.0, 4.0], [10.0, 12.0]]), torch.tensor([1, 0]), ax)
        tvis.show_box(torch.tensor([1, 2, 11, 15]), ax)
        tvis.show_anns([{"segmentation": mask.numpy(), "area": 50},
                        {"segmentation": ~mask.numpy(), "area": 550}], ax)
        tvis.show_anns([], ax)
        fig.canvas.draw()
        assert len(ax.images) == 4 and len(ax.collections) == 2 and len(ax.patches) == 1
        assert ax.patches[0].get_width() == 10 and ax.patches[0].get_height() == 13
    finally:
        plt.close(fig)


@pytest.mark.parametrize("window,steps", [((2, 2, 6), 12), ((0, 1, 3), 5), ((1, 2, 4), 5)])
def test_profiler_window_matches_jax(window, steps, tmp_path, monkeypatch):
    """The steps whose work each Profiler traces: JAX's counter, read from
    where it starts and stops jax.profiler's trace, against the record
    ranges in the port's Chrome trace. The last case ends before the window
    closes: leaving the context stops the trace."""
    wait, warmup, active = window
    events = []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: events.append(("start", step)))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: events.append(("stop", step)))
    with jexp.Profiler(str(tmp_path / "jax"), wait, warmup, active) as prof:
        for step in range(steps):
            prof.step()
    # step() after work i starts or stops the trace; leaving the context
    # stops it after the last work
    (_, first), (_, last) = events
    jax_traced = set(range(first + 1, last + 1))

    from torch.profiler import record_function

    with texp.Profiler(str(tmp_path / "port"), wait, warmup, active) as prof:
        for i in range(steps):
            with record_function(f"work{i}"):
                torch.ones(4).add_(1)
            prof.step()
    with open(prof.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    port_traced = {i for i in range(steps) if f"work{i}" in names}
    assert port_traced == jax_traced and port_traced
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "port")
    assert prof.profile.key_averages()


def test_tqdm_to_logger_matches_jax(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    writes = [("\r 10%|#  |\n", 1.0), ("", 1.0), ("\r 20%|## |", 2.0), ("30%\t", 6.0),
              ("40%", 7.0), ("50%", 12.0), ("  ", 20.0)]
    records = {}
    for name, mod in (("jax", jexp), ("port", texp)):
        logger = logging.getLogger(f"samq_test_tqdm_{name}")
        logger.propagate = False
        stream = io.StringIO()
        handler = logging.StreamHandler(stream)
        handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        logger.handlers[:] = [handler]
        logger.setLevel(logging.DEBUG)
        out = mod.TqdmToLogger(logger, level=logging.WARNING, mininterval=5.0)
        now[0] = 100.0
        for buf, dt in writes:
            now[0] += dt
            out.write(buf)
            out.flush()
        records[name] = stream.getvalue()
    assert records["port"] == records["jax"] and records["port"].count("WARNING") >= 2


def test_train_cli_takes_sbd_dir(tmp_path):
    """A JAX command line with --sbd-dir parses and trains (the flag is not read)."""
    with contextlib.redirect_stdout(io.StringIO()):
        rc = train_cli.main(["vit_tiny", "--platform", "cpu", "--exp-dir",
                             str(tmp_path / "runs"), "--steps-per-epoch", "1", "--num-clicks",
                             "1", "--sbd-dir", str(tmp_path / "no_such_dir")])
    assert rc in (0, None)
    assert (tmp_path / "runs").is_dir()
