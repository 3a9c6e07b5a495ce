"""Portable model export: ``torch.export`` programs and AOTInductor packages.

Counterpart of ``sam_quantization_tpu/export.py``. The JAX package
serializes its jitted decoder and encoder to StableHLO (``jax.export``) and
converts them through ``jax2tf`` to a TF SavedModel that a C++ program runs
with no Python (``csrc/savedmodel_runner.cpp``). The port's counterparts:

* :func:`export_decoder` / :func:`export_encoder` trace the decoder or the
  encoder with ``torch.export.export`` on fixed example shapes and save the
  ``ExportedProgram`` to a ``.pt2`` file; :func:`load_exported` loads one as
  a callable module (the StableHLO counterparts);
* :func:`export_decoder_aoti` / :func:`export_encoder_aoti` compile the same
  programs with AOTInductor for the model's device into ``model.pt2`` in a
  package directory, beside a ``manifest.txt`` that
  ``csrc/aoti_runner.cpp`` (built by ``ops._build.aoti_runner``) reads to
  run the package from C++ (the SavedModel counterparts).

The ONNX artifact is :mod:`sam_quantization_tpu_torch.export_onnx`.

:class:`SamDecoderModule` mirrors the reference's SamOnnxModel surface:
fixed-size point prompts, an optional low-res mask input gated by
``has_mask_input``, single-mask selection by IoU or stability score.

Exported programs run the encoder's eager attention, as JAX's exports take
its ``"xla"`` path, and a cached-int8 ``IntLinear`` its ``torch._int_mm``
product. A ``PackedLinear`` on the card is recorded as the custom op
``sam_quantization_tpu_torch::quant_matmul`` (``::a8_matmul`` for int8
activations; ``ops/quant_matmul.py``), whose implementation launches the
dequant-matmul kernel: a ``.pt2`` exported on the card launches it where it
runs, as JAX's export on a TPU holds ``_qmm_kernel``, and loads in a process
that imports this package. The AOTInductor runner cannot call those ops (they
launch through Python), so :func:`export_decoder_aoti` and
:func:`export_encoder_aoti` refuse a program that holds one. On the CPU a
``PackedLinear`` exports as its plain dequant-matmul, as JAX's exports hold
``quant_matmul_xla`` off the TPU.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
from torch import nn

from sam_quantization_tpu_torch.models import sam as sam_lib
from sam_quantization_tpu_torch.ops.quant_matmul import KERNEL_OPS

DECODER_INPUTS = ("image_embeddings", "point_coords", "point_labels", "mask_input",
                  "has_mask_input")
DECODER_OUTPUTS = ("masks", "iou_predictions", "low_res_masks")
ENCODER_INPUTS, ENCODER_OUTPUTS = ("image",), ("image_embeddings",)


class SamDecoderModule(nn.Module):
    """Traceable prompt -> mask decoder (JAX export.py:41-85, ref
    utils/onnx.py:17-144).

    Inputs (fixed shapes, the layout of ``sam.decode_masks``): image_embeddings
    (1, h, w, 256), point_coords (1, N, 2), point_labels (1, N), mask_input
    (1, 4h, 4w, 1), has_mask_input (1,). Outputs: masks (1, k, img, img),
    iou_predictions (1, k), low-res masks (1, k, 4h, 4w); k = 1 with
    ``return_single_mask``. It holds the model's prompt encoder and mask
    decoder only, so a program exported from it carries no encoder weight.
    """

    def __init__(self, model: sam_lib.Sam, return_single_mask: bool = True,
                 use_stability_score: bool = False, stability_score_offset: float = 1.0):
        super().__init__()
        self.prompt_encoder = model.prompt_encoder
        self.mask_decoder = model.mask_decoder
        self.img_size = model.config.image_encoder.img_size
        self.return_single_mask = return_single_mask
        self.use_stability_score = use_stability_score
        self.stability_score_offset = stability_score_offset

    def forward(self, image_embeddings, point_coords, point_labels, mask_input,
                has_mask_input) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # decode_masks reads only .prompt_encoder and .mask_decoder of its model
        low_res, iou_pred = sam_lib.decode_masks(
            self, image_embeddings, points=(point_coords, point_labels),
            mask_inputs=mask_input, mask_valid=has_mask_input > 0.5, multimask_output=True,
        )
        scores = iou_pred
        if self.use_stability_score:
            # stability score as the selection criterion (ref onnx.py:94-100)
            hi = (low_res > self.stability_score_offset).sum(dim=(-2, -1))
            lo = (low_res > -self.stability_score_offset).sum(dim=(-2, -1))
            scores = hi / torch.clamp_min(lo, 1)
        if self.return_single_mask:
            best = scores.argmax(dim=-1, keepdim=True)  # (B, 1)
            iou_out = torch.gather(iou_pred, 1, best)
            take = torch.gather(
                low_res, 1, best[:, :, None, None].expand(-1, -1, *low_res.shape[-2:]))
        else:
            take, iou_out = low_res, iou_pred
        masks = sam_lib.resize_bilinear(take, (self.img_size, self.img_size))
        return masks, iou_out, take


class _EncoderModule(nn.Module):
    """(1, img, img, 3) float32 preprocessed image -> (1, h, w, out_chans)
    embedding, on the eager attention path, in the encoder's weight dtype."""

    def __init__(self, model: sam_lib.Sam):
        super().__init__()
        self.image_encoder = model.image_encoder

    def forward(self, image):
        dtype = self.image_encoder.patch_embed.proj.weight.dtype
        return self.image_encoder(image.to(dtype), "eager")


def _decoder_program(model: sam_lib.Sam, num_points: int, return_single_mask: bool = True):
    pcfg = model.config.prompt_encoder
    h, w = pcfg.image_embedding_size
    dev = model.device
    args = (torch.zeros(1, h, w, pcfg.embed_dim, device=dev),
            torch.zeros(1, num_points, 2, device=dev),
            torch.zeros(1, num_points, device=dev),
            torch.zeros(1, 4 * h, 4 * w, 1, device=dev),
            torch.zeros(1, device=dev))
    module = SamDecoderModule(model, return_single_mask=return_single_mask).eval()
    with torch.no_grad():
        return torch.export.export(module, args)


def _encoder_program(model: sam_lib.Sam):
    size = model.config.image_encoder.img_size
    x = torch.zeros(1, size, size, 3, device=model.device)
    with torch.no_grad():
        return torch.export.export(_EncoderModule(model).eval(), (x,))


def export_decoder(model: sam_lib.Sam, path: str, num_points: int = 8,
                   return_single_mask: bool = True) -> torch.export.ExportedProgram:
    """Export the decoder with ``torch.export`` and save it to ``path`` (a
    ``.pt2`` file)."""
    program = _decoder_program(model, num_points, return_single_mask)
    torch.export.save(program, path)
    return program


def export_encoder(model: sam_lib.Sam, path: str) -> torch.export.ExportedProgram:
    """Export the (possibly quantized) image encoder with ``torch.export``
    and save it to ``path`` (the counterpart of the encoder export feeding
    the reference's PPQ/TRT pipelines, script/export_onnx.py:45-60)."""
    program = _encoder_program(model)
    torch.export.save(program, path)
    return program


def load_exported(path: str) -> nn.Module:
    """Load a ``.pt2`` written by :func:`export_decoder` or
    :func:`export_encoder` as a callable module (counterpart of an ORT
    session load)."""
    return torch.export.load(path).module()


def kernel_ops_held(program: torch.export.ExportedProgram) -> list:
    """The port's kernel ops (:data:`KERNEL_OPS`) that ``program`` calls,
    one name per call, in graph order."""
    return [n.target._schema.name for n in program.graph.nodes
            if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
            and n.target._schema.name in KERNEL_OPS]


def _aoti_package(program, directory: str, inputs, outputs) -> Dict[str, Dict[str, str]]:
    """Compile ``program`` into ``directory/model.pt2`` and write the
    runner's ``manifest.txt`` (``in <key> <position>`` / ``out <key>
    <position>`` lines); return the manifest. ``ValueError`` if the program
    holds one of the port's kernel ops (:data:`KERNEL_OPS`). The package's
    C++ is compiled by the ``g++`` on ``PATH``, as the port's other C++ is,
    not by ``$CXX``."""
    import torch._inductor

    held = sorted(set(kernel_ops_held(program)))
    if held:
        raise ValueError(
            f"AOTInductor: the program holds {', '.join(held)} (packed layers on the card), "
            "which csrc/aoti_runner.cpp cannot run: they launch the port's kernels through "
            "Python. Export such a model with export_encoder (.pt2), or serve it cached-int8.")
    os.makedirs(directory, exist_ok=True)
    with torch._inductor.config.patch({"cpp.cxx": (None, "g++")}):
        torch._inductor.aoti_compile_and_package(
            program, package_path=os.path.join(directory, "model.pt2"))
    manifest = {"inputs": {k: str(i) for i, k in enumerate(inputs)},
                "outputs": {k: str(i) for i, k in enumerate(outputs)}}
    with open(os.path.join(directory, "manifest.txt"), "w") as fh:
        for kind, part in (("in", "inputs"), ("out", "outputs")):
            for key, position in manifest[part].items():
                fh.write(f"{kind} {key} {position}\n")
    return manifest


def export_decoder_aoti(model: sam_lib.Sam, directory: str, num_points: int = 8,
                        return_single_mask: bool = True) -> Dict[str, Dict[str, str]]:
    """Compile the decoder with AOTInductor for the model's device into a
    package directory that ``csrc/aoti_runner.cpp`` runs with no Python (the
    counterpart of the JAX package's SavedModel export, itself standing for
    the reference's TRT/PPLNN engines, trt_infer.py:142-313). Returns the
    manifest ``{inputs: {key: position}, outputs: ...}``, also written as
    ``manifest.txt``. Unlike JAX's SavedModel export, it takes
    ``return_single_mask``."""
    return _aoti_package(_decoder_program(model, num_points, return_single_mask), directory,
                         DECODER_INPUTS, DECODER_OUTPUTS)


def export_encoder_aoti(model: sam_lib.Sam, directory: str) -> Dict[str, Dict[str, str]]:
    """Compile the (possibly quantized, e.g. cached-int8) image encoder with
    AOTInductor for the model's device into a package directory for
    ``csrc/aoti_runner.cpp``; same manifest as :func:`export_decoder_aoti`."""
    return _aoti_package(_encoder_program(model), directory, ENCODER_INPUTS, ENCODER_OUTPUTS)


def load_aoti(directory: str):
    """Load a package directory's ``model.pt2`` as a Python callable."""
    import torch._inductor

    return torch._inductor.aoti_load_package(os.path.join(directory, "model.pt2"))
