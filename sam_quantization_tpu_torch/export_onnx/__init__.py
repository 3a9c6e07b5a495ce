"""ONNX opset-11 export of SAM's decoder and image encoder, with no ``onnx``
or ``protobuf`` package.

Counterpart of ``sam_quantization_tpu/export_onnx``. The graphs are built
explicitly, node for node as the JAX package builds them
(:mod:`.decoder_graph`, :mod:`.encoder_graph`), written through the port's
own protobuf wire codec (:mod:`._wire`), and validated by an independent
numpy interpreter (:mod:`.runtime`)::

    from sam_quantization_tpu_torch import export_onnx
    blob = export_onnx.export_decoder_onnx(model, "decoder.onnx")
    rt = export_onnx.runtime.load("decoder.onnx")       # no onnxruntime
    out = rt.run({"image_embeddings": ..., "point_coords": ..., ...})

For the same weights and ``producer`` (the JAX package's is
``"sam_quantization_tpu"``) the bytes equal the JAX package's. The weights
are read on the host, so a model on the card gives the same bytes as its
copy on the CPU. CLI: ``python -m sam_quantization_tpu_torch.cli.export
--format onnx``.
"""

from __future__ import annotations

from sam_quantization_tpu_torch.export_onnx import runtime  # noqa: F401
from sam_quantization_tpu_torch.export_onnx._wire import serialize
from sam_quantization_tpu_torch.export_onnx.builder import PRODUCER
from sam_quantization_tpu_torch.export_onnx.decoder_graph import build_decoder_graph
from sam_quantization_tpu_torch.export_onnx.encoder_graph import build_encoder_graph

OPSET = 11


def _write(blob: bytes, path) -> bytes:
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_decoder_onnx(
    model,
    path: str = None,
    num_points: int = 8,
    return_single_mask: bool = True,
    use_stability_score: bool = False,
    stability_score_offset: float = 1.0,
    producer: str = PRODUCER,
) -> bytes:
    """Serialize ``model``'s prompt encoder + mask decoder to ONNX bytes
    (opset 11, IR v7) and optionally write them to ``path``.

    Mirrors :class:`sam_quantization_tpu_torch.export.SamDecoderModule`
    numerically; I/O names and layout follow the reference's SamOnnxModel
    (segment_anything/utils/onnx.py:17-144), so ORT and browser consumers
    take it as they are.
    """
    g = build_decoder_graph(
        model,
        num_points=num_points,
        return_single_mask=return_single_mask,
        use_stability_score=use_stability_score,
        stability_score_offset=stability_score_offset,
    )
    return _write(serialize(g.build_model(OPSET, producer)), path)


def export_encoder_onnx(model, path: str = None, producer: str = PRODUCER) -> bytes:
    """Serialize ``model``'s image encoder (dense linears) to ONNX bytes
    (opset 11).

    Counterpart of the reference PPQ path's encoder export
    (script/custimized_quant.py:334-344); input "input" is the NCHW
    preprocessed image, output "image_embeddings" feeds the decoder graph.
    Raises ``ValueError`` for an encoder whose weights pass protobuf's 2 GiB
    limit (ViT-H), before anything is serialized.
    """
    return _write(serialize(build_encoder_graph(model).build_model(OPSET, producer)), path)
