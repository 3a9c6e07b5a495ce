"""Quickest proof that the PyTorch + CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card. It

1. prints the card's name and power limit, and the torch / CUDA versions;
2. builds every kernel from ``sam_quantization_tpu_torch/csrc`` (nvcc, into
   ``build/torch_kernels/``);
3. kernel phase: holds each kernel against its plain PyTorch version at the
   ViT-H shapes of the main paths (float32, bfloat16, and the int8 epilogue;
   the head-split kernel at the training shape, rel-less, and at long L with
   and without a rel grid, and the five probe kernels at the probes' shapes,
   each also showing that its bound rejects a wrong output, the packed-weight
   kernels' being their plain version with x's last K tile left out, also at
   pack blocks of 48 and 96 rows, which are not powers of two; the bfloat16
   serving attention kernels, packed-weight kernels and the TMA attention
   body (P1-P5, bfloat16 ``flash_whole`` and ``flash_rowblock``) also show
   their tensor-core instructions, the HGMMA count that ``cuobjdump -sass``
   finds in each instantiation (and no other kernel in the probes'
   libraries; in ``flash_attn``'s, float32 kernels of FFMA and no
   tensor-core instruction beside them), and the W-A8 kernels
   their IGMMA (int8 wgmma, main
   build) and IMMA (int8 mma.sync, FINE build) counts; the W-A8 kernels'
   bound rejects their plain version with x's last K tile left out too),
   and times the kernel, the plain version, and one
   PyTorch library call of the same function, a yardstick the port never
   calls: ``scaled_dot_product_attention`` with the bias materialised as
   ``attn_mask`` for attention, ``torch.matmul`` on the weight dequantized
   beforehand for the dequant-matmuls, dense lin1 -> tanh GELU -> lin2
   for the fused MLP, and ``torch._int_mm`` on the weight unpacked to int8
   beforehand (one group, no scales) for the W-A8 kernels, which are held
   against their plain version on the same int8 input, two ``torch.bmm``
   for the dot-only probes, and ``scaled_dot_product_attention`` with scale
   ln 2 (the bias times ln 2 as ``attn_mask``) for the softmax probes;
4. dense main path: builds ViT-H from seeded random weights (rel-pos tables
   filled, so the bias contributes), encodes a 1024x1024 image with the
   kernel path and the plain (eager) path in float32 and bfloat16 and
   compares them, then serves 1200x1600 uint8 images through ``SamPredictor``
   with a bfloat16 encoder (set_image, three clicks, the later two with the
   previous low-res mask): the launch counters are reset just before the
   first served image and read just after it, and the times are the median
   and spread over all served images;
5. W4 main path: the same ViT-H, RTN-quantized to 4 bits (group 128) by the
   port; its kernel-path embedding is held against the dense model of the
   dequantized weights on the eager path (float32 and bfloat16), then it is
   served like the dense model, with exact launch counts per image, and one
   ``set_image`` is profiled;
6. W3 encode: the same ViT-H at 3 bits, one bfloat16 encode with its
   launch counts, held against its dequantized dense model;
7. W4A8 main path: the same ViT-H, RTN symmetric 4-bit (group 128) with
   int8 activations on every block linear (``bench.py --a8``'s
   configuration): held against its dequantized dense model (float32 and
   bfloat16), served like the others with exact launch counts, and one
   ``set_image`` profiled with the per-token quantize pass's share; then one
   bfloat16 encode of the asymmetric W4A8 model;
8. small inputs: vit_tiny predictors, dense, W4 and W4A8, on the card
   against the same models on the CPU;
9. rel-less ViT-H encode (``use_rel_pos=False``): 28 ``flash_whole`` and 4
   ``flash_rowblock`` launches, held against the eager path (float32 and
   bfloat16);
10. cached-int8 ViT-H (``bench.py``'s default mode): RTN symmetric 4-bit
    (group 128), static activation scales calibrated on one seeded image
    (margin 1.1), ``cache_int8`` with ``default_serve_skip(1280)``: held
    against its dequantized dense model (float32 and bfloat16), served like
    the others with exact launch counts (all 32 attention launches with the
    int8 epilogue feeding an int8-pre proj; 128 int8 products), and one
    ``set_image`` profiled by part (int8 products, quantize passes,
    epilogues, attention);
11. the two stage probes (``tools/packed_probe``, ``tools/global_stage_probe``)
    run once at ViT-H: the only path of the five probe kernels (P1-P5), whose
    launch counts are read around it;
12. click-loop evaluation (``evaluation/``): the main-path gate, the
    committed ``checkpoints/vit_tiny_synth`` in float32 through the kernels,
    24 scenes x 5 clicks (click seed 123, literal layout) against
    CROSSVAL.json's ``jax_mean_ious`` within 1e-3 (48 ``flash_windowed`` and
    48 ``flash_whole`` launches), with the port's C++ host runtime loaded;
    then ViT-H (bf16 encoder, dense) through ``click_loop_eval`` on 3 seeded
    1024 scenes x 5 clicks (28/4 flash launches a scene, IoUs in [0, 1],
    every click in the error region of the mask before it; encode and
    per-click ms) and ``noc_eval`` to 3 clicks, and one flip-TTA
    ``SamEvalPredictor`` (2 clicks, 3 ``set_image``);
13. ViT-H fine-tuning in float32 (``train/``): a one-click gradient check of
    ``flash_train`` against eager on the same weights and click, then
    training steps with 11 clicks and AdamW (exactly 28 ``flash_whole``
    launches and no other kernel per step, finite losses, parameters that
    move, step times and peak memory, one profiled step), and a checkpoint
    save/load round trip in the JAX trainer's format from the card, bit for
    bit (on a vit_tiny trained two steps there);
14. GPTQ (``quant/gptq.py``, ``quant/sequential.py``, ``cli/quantize.py``):
    the solver on the card against the same solver on the CPU at ViT-H's
    lin2 and qkv widths (W4 g128; share of equal grid values, largest step,
    loss gap); then ``cli.quantize`` GPTQ W4 g128 of the seeded ViT-H on the
    card (2 synthetic 1024 scenes; seconds, the column loop's share, the
    128 losses), its artifact loaded as ``cli.infer --load`` loads it and
    served in float32 and bfloat16 with W4's exact launch counts and held
    against its dequantized dense model; the GPTQ and RTN encoders' errors
    on a held-out scene are printed as a reading.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. It exits non-zero, without that
line, when there is no CUDA device, when the package is missing, or when any
check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# CUDA-core fp32, dense bf16 tensor, dense int8 tensor (operations per second)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
SERVED_IMAGES = 7  # timed images; the first is also the one the launch counts read
# Embedding tolerances (rel. L2) of the quantized encoders against the dense
# model of their dequantized weights on the eager path, in float32:
W4_F32_TOL = 1e-2  # flash kernels vs eager, and the fused MLP's tanh GELU vs erf
BF16_TOL = 5e-2  # bf16 rounding over 32 blocks (as the dense bf16 check)
# W4A8 adds the per-token int8 rounding of every block linear's input (up to
# 1/254 of the row's amax per value, over 128 matmuls). Limits set from the
# first H100 run on these seeded weights: float32 measured 1.73e-2, so 3e-2;
# bf16 measured 2.25e-2, the bf16 (1.45e-2) and int8 errors adding in
# quadrature, so BF16_TOL.
A8_F32_TOL = 3e-2
A8_BF16_TOL = BF16_TOL
# vit_tiny W4A8, card vs CPU: an ulp of difference before a linear can move a
# value across an int8 rounding point, which moves that product by one
# activation step (measured 1.9e-3 on the low-res logits).
A8_TINY_TOL = 1e-2
QUANT_RANGE = "quantize_activations_int8"  # profiler range around the quantize pass
# An attention kernel vs its plain version in bfloat16 (the head-split
# kernel, the probes, and the tensor-core windowed and global kernels): both
# round p and the output to bf16 from float32 sums taken in another order, so
# an output may sit one bf16 step away: |d| <= 2**-7 |ref| + HS_BF16_C
# max|ref|. On an H100 the tensor-core kernels (P1 among them since it left
# the CUDA cores, where it read c <= 0) read 1e-4 to 6e-4 (a flipped p or s
# rounding, or the wgmma sum order moving an output across a rounding
# point), and the plain version with its last key tile skipped in p.v reads
# 0.16 to 1.05; HS_BF16_C leaves room for both.
HS_BF16_C = 2.0**-10
# P3 on the probe driver's own unscaled q (logits of std ~9): a p near 1
# that rounds to bf16 on either side with the last bit of s moves a row by
# two output steps, and the plain version itself reads 1.037e-3 (exp2) and
# 7.5e-4 (exp) from a float64 evaluation on an H100, above HS_BF16_C for
# exp2. There the kernel is held within P3_RAW_C of the plain version and no
# farther from float64 than the larger of HS_BF16_C and P3_F64_MARGIN times
# the plain version's own reading (it read 1.041e-3 / 9.05e-4 and 9.9e-4 /
# 9.05e-4); the plain version with its last key tile skipped must fail both.
P3_RAW_C = 2.0**-9
P3_F64_MARGIN = 1.25
TRAIN_STEPS = 4  # timed ViT-H training steps (one more is profiled)
# One-click flash_train vs eager on identical weights and click: the forward
# differs only by the kernel's clamped exp2 softmax and float32 sum order.
# Limits set from the first H100 runs on these seeded weights: loss rel.
# 9.2e-8, so 1e-6; the whole gradient's rel. L2 3.7e-7, so 1e-5; the worst
# leaf 2.4e-4 (a key bias, whose exact gradient is zero: both sides are
# float32 noise at the floor below), so 1e-3.
TRAIN_LOSS_TOL = 1e-6
TRAIN_GRAD_TOL = 1e-5
TRAIN_LEAF_TOL = 1e-3
GRAD_FLOOR = 1e-6  # leaf gradients below this share of the whole are noise
# Parameters whose change shows that the steps trained the whole model.
TRAIN_WATCH = ("image_encoder.blocks.0.attn.qkv.weight", "image_encoder.blocks.0.attn.rel_pos_h",
               "image_encoder.blocks.31.mlp.lin2.weight", "mask_decoder.iou_token.weight",
               "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix")
# The JSON row of each kernel is its bfloat16 kernel-phase case, except
# flash_whole's, which is the float32 training shape its launches come from.
JSON_DTYPE = {"flash_whole": "float32"}
# Cached-int8 ViT-H against the dense model of its dequantized 4-bit weights on
# the eager path: adds the per-channel int8 requantization of the weights and
# the int8 rounding of every linear's input at one static scale per layer,
# coarser than W4A8's per-token one for tokens below the layer's amax. Limits
# set from the first H100 run on these seeded weights: float32 measured
# 2.98e-2, so 4e-2; bf16 3.32e-2 (the bf16 1.45e-2 and the int8 errors adding
# in quadrature), so BF16_TOL.
INT8_F32_TOL = 4e-2
INT8_BF16_TOL = BF16_TOL
# Its kernel branch against the eager branch of the same cached-int8 model:
# both take the same int8 weights, static scales and exact integer products,
# and differ by the attention's rounding and, in bf16, by where proj's input
# is quantized (the kernels' int8-out epilogue against a bf16 attention
# output). An input within rounding of an int8 midpoint flips by one step,
# and over 32 blocks the flips cascade until the two branches carry
# independent-looking int8 noise. First H100 run on these seeded weights:
# float32 3.27e-2, bf16 4.02e-2, so 4e-2 and 5e-2.
INT8_KERNEL_TOL = {"float32": 4e-2, "bfloat16": 5e-2}
# The same block by block on the same input (block 0 windowed, block 7
# global), read as the rel. L2 of the block's residual update: one block's
# flips with no cascade, where a fault in the int8-out epilogue or the
# int8-pre proj would stand out. First H100 run: float32 1.07e-3 and 1.65e-3,
# so 2.5e-3; bf16 2.35e-2 and 1.91e-2 (the eager branch also rounds p and
# the attention output to bf16), so 3e-2.
INT8_BLOCKS = (0, 7)
INT8_BLOCK_TOL = {"float32": 2.5e-3, "bfloat16": 3e-2}
LN2 = math.log(2.0)
PROBE_ITERS = 3  # --iters of the probe drivers' run
# Calls of each probe kernel in that run: timing.timed_ms makes one warm-up
# call and three repeats of --iters calls for each case; P1-P3 are one case
# each of packed_probe, P4 and P5 two cases each (the row-max and the clamp-40
# softmax) of global_stage_probe.
PROBE_CASES = {"probe_no_softmax": 1, "probe_dots_floor": 1, "probe_presplit": 1,
               "probe_pair": 2, "probe_pair_bias": 2}
PROBE_LAUNCHES = {name: n * (1 + 3 * PROBE_ITERS) for name, n in PROBE_CASES.items()}
# The click-loop gate (ROADMAP's North star): vit_tiny_synth's per-click mean
# IoU over CROSSVAL.json's 24 scenes x 5 clicks (click seed 123, literal
# layout) within GATE_TOL of its jax_mean_ious; vit_tiny runs 2 windowed
# blocks (flash_windowed) and 2 global ones of 64 tokens (flash_whole) an image.
GATE_TOL = 1e-3
GATE_SCENES, GATE_CLICKS, GATE_SEED = 24, 5, 123
TINY_LAUNCHES = {"flash_windowed": 2, "flash_whole": 2}  # per vit_tiny encode
EVAL_SCENES, EVAL_CLICKS, NOC_CLICKS = 3, 5, 3  # the ViT-H click loop, NoC and TTA
# GPTQ solver on the card against the same solver on the CPU, for the same
# W and H. The solver takes its library-ordered sums (Cholesky chain, block
# tails) in float64 and rounds once, so the two devices compute the same
# grid unless a float64 difference straddles a float32 rounding point; the
# error fed forward from a flipped weight can move later ones by a step.
GPTQ_SHARE = 0.999  # least share of equal grid values
GPTQ_LOSS_REL = 1e-3
FAILURES = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def tensor_core_counts(library: pathlib.Path, nvcc: str, pattern: str) -> dict:
    """{key: (HGMMA, HMMA, IMMA, IGMMA, FFMA)} of each instantiation whose
    mangled name matches ``pattern`` in a built library's SASS, as
    ``cuobjdump -sass`` lists it: bf16 wgmma, bf16 mma.sync, int8 mma.sync,
    int8 wgmma and float32 fma. The key is the pattern's groups: (head dim
    tile, out type) of the bfloat16 attention kernels (``*_tc_kernel<HDP,
    OutT>``), (bits, epilogue) of the packed-weight body (``qmm_tc_kernel<BITS,
    EPI>``), (bits, sym, fine, out type) of the W-A8 kernels, (mode, exp2,
    bias, head dim tile) of the TMA attention body (``probe_tc_kernel``) and
    the name of a CUDA-core kernel."""
    import re

    cuobjdump = pathlib.Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            key = m.groups() if m else None
            if key:
                counts[key] = [0, 0, 0, 0, 0]
        elif key and "HGMMA" in line:
            counts[key][0] += 1
        elif key and "HMMA" in line:
            counts[key][1] += 1
        elif key and "IMMA" in line:
            counts[key][2] += 1
        elif key and "IGMMA" in line:
            counts[key][3] += 1
        elif key and "FFMA" in line:
            counts[key][4] += 1
    return {k: tuple(v) for k, v in counts.items()}


def print_device_profile(what: str, fn, ranges=()) -> dict:
    """Run ``fn`` once under torch.profiler; print device time by kernel, the
    kernel groups, and the share of the wall time the device was busy. Each
    ``(module, function name, range name)`` of ``ranges`` runs inside a
    profiler range for this run only, and its device time is printed.
    Returns the device ms of each kernel group and range."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for mod, attr, name in ranges:
        real = getattr(mod, attr)

        def traced(*a, real=real, name=name, **kw):
            with record_function(name):
                return real(*a, **kw)

        saved.append((mod, attr, real))
        setattr(mod, attr, traced)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    events = prof.key_averages()
    names = {name for _, _, name in ranges}
    # Ranges (the traced functions', the optimizer's step) span kernels that
    # are counted on their own.
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in events
         if e.device_type == DeviceType.CUDA and e.key not in names
         and not e.key.startswith("Optimizer.")), reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {"attention kernels": 0.0, "quant kernels": 0.0, "matmul": 0.0, "memcpy": 0.0,
              "other": 0.0}
    for ms, _, key in rows:
        group = ("attention kernels" if "flash_" in key else
                 "quant kernels" if "qmm_" in key or "fused_mlp" in key else
                 "matmul" if any(s in key for s in ("gemm", "nvjet", "cutlass", "xmma")) else
                 "memcpy" if key.startswith("Memcpy") else "other")
        groups[group] += ms
    print(f"profile {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), " + ", ".join(
              f"{g} {ms:.2f} ms" for g, ms in groups.items()))
    spent = dict(groups)
    for _, _, name in ranges:
        spans = [e for e in events if e.key == name and e.device_type == DeviceType.CPU]
        ms = spent[name] = sum(e.device_time_total for e in spans) / 1e3
        print(f"  {name}: {ms:.2f} ms device time over {sum(e.count for e in spans)} "
              f"calls ({100 * ms / busy:.1f}% of busy), in the groups above")
    for ms, count, key in rows[:10]:
        print(f"  {ms:9.3f} ms {count:5d}x  {key[:100]}")
    return spent


def gptq_solver_phase(dev, card: str) -> None:
    """GPTQ (a): ``gptq_quantize_matrix`` on the card against the same solver
    on the CPU, W4 g128 asymmetric, at ViT-H's lin2 (N 1280, K 5120) and qkv
    (N 3840, K 1280). The weights and the rows are seeded numpy; the rows
    are mixed by a random K x K map, so that H has off-diagonal mass and the
    error feedback matters. H = (2 / B) Σ xᵀx over B = 2 batches of 4096
    rows is taken once on the card, and both solvers get it."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.quant import gptq as gptq_lib

    for name, N, K in (("lin2", 1280, 5120), ("qkv", 3840, 1280)):
        r = np.random.default_rng(21)
        w = torch.from_numpy(r.standard_normal((N, K), dtype=np.float32) * 0.02)
        mix = torch.from_numpy(r.standard_normal((K, K), dtype=np.float32) / math.sqrt(K)).to(dev)
        h = torch.zeros((K, K), device=dev)
        for _ in range(2):
            z = torch.from_numpy(r.standard_normal((4096, K), dtype=np.float32)).to(dev)
            xb = z + z @ mix
            h += xb.t() @ xb
        h *= 2.0 / 2
        kw = dict(bits=4, groupsize=128)
        torch.cuda.synchronize()
        t = time.perf_counter()
        gptq_lib._prepare_hinv(h, 0.01)
        torch.cuda.synchronize()
        hinv_s = time.perf_counter() - t
        t = time.perf_counter()
        on_card = gptq_lib.gptq_quantize_matrix(w.to(dev), h, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        on_cpu = gptq_lib.gptq_quantize_matrix(w, h.cpu(), **kw)
        cpu_s = time.perf_counter() - t
        qg, qc = on_card.q_int.cpu(), on_cpu.q_int
        share = float((qg == qc).double().mean())
        dq = int((qg - qc).abs().max())
        lg, lc = float(on_card.loss), float(on_cpu.loss)
        rel = abs(lg - lc) / abs(lc)
        check(share >= GPTQ_SHARE and dq <= 1 and rel <= GPTQ_LOSS_REL,
              f"GPTQ solver {name} (N {N}, K {K}) W4 g128, card vs CPU: q_int equal on "
              f"{share:.6%} (>= {GPTQ_SHARE:.1%}), max|dq| {dq} (<= 1), loss {lg:.6g} vs "
              f"{lc:.6g} (rel {rel:.2e} <= {GPTQ_LOSS_REL}); card {card_s:.2f} s (H⁻¹ "
              f"{hinv_s:.3f} s, the column loop and block tails the rest), CPU {cpu_s:.2f} s  "
              f"[{card}]")


def gptq_encoder_phase(dev, card: str, name: str, build, image, launches: dict,
                       reset_counts, counts, workdir: pathlib.Path) -> None:
    """GPTQ (b): ``cli.quantize`` GPTQ W4 g128 of the seeded model that
    ``build()`` returns (saved as a SAM ``.pth`` for ``--checkpoint``; 2
    synthetic calibration scenes), loaded as ``cli.infer --load`` loads it
    and served on ``image`` in float32 and bfloat16 with exactly
    ``launches``; its embedding held against the dense model of its
    dequantized weights (W4_F32_TOL, BF16_TOL); and, as a reading only, the
    encoder's rel. error of GPTQ and of RTN W4 against the float32 model on
    a held-out scene."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.cli import build_model
    from sam_quantization_tpu_torch.cli import quantize as quantize_cli
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.predictor import SamPredictor
    from sam_quantization_tpu_torch.quant import gptq as gptq_lib
    from sam_quantization_tpu_torch.quant import sequential as seq

    phase_t = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    model = build()
    pth = workdir / f"{name}_seeded.pth"
    torch.save(model.state_dict(), pth)
    size, depth = model.config.image_encoder.img_size, model.config.image_encoder.depth
    x = torch.randn((1, size, size, 3), generator=torch.Generator(device=dev).manual_seed(31),
                    device=dev)
    scene = next(synthetic_samples(1, size, seed=7))[0]  # held out: calibration uses seed 0
    held_out = sam_lib.preprocess(model, torch.from_numpy(scene).to(dev))
    with torch.no_grad():
        fp_out = model.image_encoder(held_out, "eager").float()
        rtn = seq.rtn_quantize_encoder(model.image_encoder, seq.GPTQConfig(bits=4, groupsize=128))
        rtn_err = float((rtn(held_out, "eager").float() - fp_out).norm() / fp_out.norm())
    del model, rtn

    # The solver's time, and of it the Cholesky chain's; the rest of the
    # solver is the column loop (with the block tails and the group grids).
    spent = {"solver": 0.0, "hinv": 0.0}

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return run

    art = workdir / "gptq_w4g128"
    argv = [name, "--checkpoint", str(pth), "--nsamples", "2", "--wbits", "4", "--groupsize",
            "128", "--save", str(art)]
    solve, hinv = gptq_lib.gptq_quantize_matrix, gptq_lib._prepare_hinv
    gptq_lib.gptq_quantize_matrix, gptq_lib._prepare_hinv = timed(solve, "solver"), timed(hinv, "hinv")
    out = io.StringIO()
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = quantize_cli.main(argv)
        quant_s = time.perf_counter() - t
    finally:
        gptq_lib.gptq_quantize_matrix, gptq_lib._prepare_hinv = solve, hinv
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    with open(art / "quant_config.json") as f:
        losses = json.load(f)["losses"]
    loop_s = spent["solver"] - spent["hinv"]
    check(rc == 0 and last["status"] == "ok" and len(losses) == 4 * depth
          and all(math.isfinite(v) for v in losses.values()),
          f"cli.quantize {name} GPTQ W4 g128 on the card: {quant_s:.1f} s (cli {last['elapsed_s']} s); "
          f"solver {spent['solver']:.1f} s: H⁻¹ {spent['hinv']:.1f} s, column loop {loop_s:.1f} s "
          f"({loop_s / quant_s:.1%} of the run); {len(losses)} losses, all finite, "
          f"{min(losses.values()):.4g} to {max(losses.values()):.4g}  [{card}]")

    # Loaded as cli.infer --load loads it: the dense rest from the .pth, the
    # packed encoder from the artifact.
    qmodel, _ = build_model(argparse.Namespace(model=name, checkpoint=str(pth), ckpt_name="best",
                                               load=str(art)), dev)
    h, w = image.shape[:2]
    with torch.no_grad():
        ref = packed_lib.dense_copy(qmodel.image_encoder)(x, "eager").float()
        gptq_out = qmodel.image_encoder(held_out, "eager").float()
        for dtype, tol in ((torch.float32, W4_F32_TOL), (torch.bfloat16, BF16_TOL)):
            tag = str(dtype).split(".")[1]
            qmodel.image_encoder.to(dtype)
            predictor = SamPredictor(qmodel)
            reset_counts()
            predictor.set_image(image)
            masks, iou, low = predictor.predict(np.array([[w / 2, h / 2]]), np.array([1.0]))
            torch.cuda.synchronize()
            got = counts()
            check(got == launches and masks.shape == (3, h, w) and np.isfinite(iou).all()
                  and np.isfinite(low).all(),
                  f"GPTQ W4 {name} served {tag} ({h}x{w}, one click): launches "
                  f"{ {k: v for k, v in got.items() if v} }, masks {masks.shape}, finite")
            e = sam_lib.encode_image(qmodel, x.to(dtype), "kernel").float()
            rel_err = float((e - ref).norm() / ref.norm())
            check(bool(torch.isfinite(e).all()) and rel_err <= tol,
                  f"GPTQ W4 {name} encode {tag} vs dequantized dense float32 eager: rel L2 "
                  f"{rel_err:.3e} (<= {tol})")
    gptq_err = float((gptq_out - fp_out).norm() / fp_out.norm())
    print(f"GPTQ W4 g128 {name}, held-out scene, encoder rel. L2 vs float32 (random weights, "
          f"a reading): GPTQ {gptq_err:.4e}, RTN {rtn_err:.4e}")
    del qmodel, ref, fp_out, gptq_out
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"GPTQ phase ({name}): {time.perf_counter() - phase_t:.1f} s  [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as TF

    from sam_quantization_tpu_torch import native
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.evaluation import click_eval
    from sam_quantization_tpu_torch.evaluation.clicker import Clicker
    from sam_quantization_tpu_torch.evaluation.predictors import SamEvalPredictor
    from sam_quantization_tpu_torch.models import build_sam, configs
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS
    from sam_quantization_tpu_torch.nn import functional as nn_fn
    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.ops import _build
    from sam_quantization_tpu_torch.ops import flash_attention as fa
    from sam_quantization_tpu_torch.ops import fused_mlp as fm
    from sam_quantization_tpu_torch.ops import probes as ps
    from sam_quantization_tpu_torch.ops import quant_matmul as qm
    from sam_quantization_tpu_torch.predictor import SamPredictor
    from sam_quantization_tpu_torch.quant import act_scales as act_lib
    from sam_quantization_tpu_torch.quant import sequential as seq
    from sam_quantization_tpu_torch.tools import global_stage_probe, packed_probe
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib
    from sam_quantization_tpu_torch.train import trainer as trainer_lib

    dev = torch.device("cuda")
    card = gpu_line()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {name}: {line.strip()}")

    # Proof that the bfloat16 serving attention runs on the tensor cores:
    # each of its 16 instantiations (hd tiles 16..128, bf16 and int8 out) in
    # both libraries holds HGMMA (wgmma) instructions.
    for name in ("flash_windowed", "flash_global"):
        tc_counts = tensor_core_counts(_build.library_path(name), _build._nvcc(),
                                       r"tc_kernelILi(\d+)E(13__nv_bfloat16|a)E")
        check(len(tc_counts) == 16 and all(c[0] + c[1] > 0 for c in tc_counts.values()),
              f"{name} bf16 instantiations, HGMMA/HMMA in SASS: " + ", ".join(
                  f"hd{hdp} {'int8' if out == 'a' else 'bf16'} {c[0]}/{c[1]}"
                  for (hdp, out), c in sorted(tc_counts.items())))
    # And the bfloat16 packed-weight kernels: every instantiation of their
    # body (qmm_tc_kernel<BITS, EPI>) holds HGMMA, bits 2, 3, 4, 8 in
    # quant_matmul (plain epilogue), bits 2, 4, 8 in fused_mlp (both).
    for name, want in (("quant_matmul", {(b, "0") for b in ("2", "3", "4", "8")}),
                       ("fused_mlp", {(b, e) for b in ("2", "4", "8") for e in ("0", "1")})):
        tc_counts = tensor_core_counts(_build.library_path(name), _build._nvcc(),
                                       r"qmm_tc_kernelILi(\d+)ELi(\d+)E")
        check(set(tc_counts) == want and all(c[0] > 0 for c in tc_counts.values()),
              f"{name} bf16 instantiations, HGMMA in SASS: " + ", ".join(
                  f"W{b} epilogue {e} {c[0]}" for (b, e), c in sorted(tc_counts.items())))
    # The W-A8 kernels (bits 2, 4, 8; sym and asym; float32 and bf16 out):
    # the 12 main-build instantiations run int8 wgmma (IGMMA), the 12 FINE
    # ones int8 mma.sync (IMMA).
    tc_counts = tensor_core_counts(_build.library_path("quant_matmul_a8"), _build._nvcc(),
                                   r"qmm_a8_kernelILi(\d+)ELb(\d)ELb(\d)E(13__nv_bfloat16|f)E")
    want = {(b, s, o) for b in ("2", "4", "8") for s in ("0", "1") for o in ("f", "13__nv_bfloat16")}
    for fine, ins, i in (("0", "IGMMA", 3), ("1", "IMMA", 2)):
        build = {(b, s, o): c for (b, s, f, o), c in tc_counts.items() if f == fine}
        check(set(build) == want and all(c[i] > 0 for c in build.values()),
              f"quant_matmul_a8 {'FINE' if fine == '1' else 'main'} build, {ins} in SASS: "
              f"{len(build)} instantiations, "
              f"{min((c[i] for c in build.values()), default=0)}-"
              f"{max((c[i] for c in build.values()), default=0)} {ins} each")

    # The TMA tensor-core body (probe_tc_kernel<MODE, EXP2, BIAS, HDP>, hd
    # tiles 16..128): in probe_heads, the dot-only mode (P2), the row-max
    # and clamp-40 softmax without a bias (P3 row max exp2 and exp, P4 both)
    # and with one (P5 both), 48 instantiations; in probe_packed, P1's AUG
    # mode (4), 8; in flash_attn, the FLASH mode of bfloat16 flash_whole and
    # flash_rowblock, with and without a rel grid, 16. Each holds HGMMA, so
    # no bfloat16 launch of those kernels can reach an FFMA product loop.
    # Beside them flash_attn holds only the float32 register-tiled body
    # (flash_attn_f32_kernel<HDP, REL>, 16): FFMA, and no HGMMA or HMMA
    # (tensor cores would mean TF32); the probes' libraries hold no other
    # kernel.
    hdps = [str(h) for h in range(16, 129, 16)]
    for name, want in (("probe_heads", {(m, e, b, h) for m, e, b in (
            ("0", "1", "0"), ("1", "1", "0"), ("1", "0", "0"), ("2", "1", "0"), ("1", "1", "1"),
            ("2", "1", "1")) for h in hdps}),
            ("probe_packed", {("4", "1", "0", h) for h in hdps}),
            ("flash_attn", {("3", "1", b, h) for b in "01" for h in hdps})):
        lib = _build.library_path(name)
        tc_counts = tensor_core_counts(lib, _build._nvcc(),
                                       r"probe_tc_kernelILi(\d)ELb(\d)ELb(\d)ELi(\d+)E")
        check(set(tc_counts) == want and all(c[0] > 0 for c in tc_counts.values()),
              f"{name}: {len(tc_counts)} probe_tc_kernel instantiations (mode, exp2, bias), HGMMA "
              f"{min((c[0] for c in tc_counts.values()), default=0)}-"
              f"{max((c[0] for c in tc_counts.values()), default=0)} each, FFMA "
              f"{min((c[4] for c in tc_counts.values()), default=0)}-"
              f"{max((c[4] for c in tc_counts.values()), default=0)}")
        cuda_core = tensor_core_counts(lib, _build._nvcc(), r"flash_attn_f32_kernelILi(\d+)ELb(\d)E")
        others = sorted(k[0] for k in tensor_core_counts(lib, _build._nvcc(), r"Function : (\w+)")
                        if "probe_tc_kernel" not in k[0] and "flash_attn_f32_kernel" not in k[0])
        check(not others, f"{name}: no kernel but probe_tc_kernel and flash_attn_f32_kernel "
                          f"({others})")
        if name == "flash_attn":
            check(set(cuda_core) == {(h, r) for h in hdps for r in "01"}
                  and all(c[4] > 0 and c[0] == c[1] == 0 for c in cuda_core.values()),
                  "flash_attn: float32 flash_attn_f32_kernel (HDP, rel), FFMA and no HGMMA/HMMA: "
                  + ", ".join(f"{h}/{r} {c[4]}/{c[0] + c[1]}"
                              for (h, r), c in sorted(cuda_core.items(), key=lambda x: int(x[0][0]))))
        else:
            check(not cuda_core, f"{name}: no float32 head-split kernel")

    gen = torch.Generator(device=dev)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def cuda_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def reset_counts():
        for mod in (fa, qm, fm, ps):
            mod.reset_launch_counts()

    def counts():
        """Kernel launches, int8-out epilogues and int8 products (cuBLAS)."""
        return {**fa.LAUNCHES, **qm.LAUNCHES, **fm.LAUNCHES, **ps.LAUNCHES, **qm.INT8_MATMULS,
                **{f"{k} int8-out": c for k, c in fa.INT8_OUT.items()}}

    zero = {name: 0 for name in counts()}

    def rel_ok(out, ref, dtype):
        """Packed-weight kernels: both sides multiply the same values and
        differ in the float32 sum order. float32 |d| <= 1e-5 |ref| + 1e-4
        max|ref|; bfloat16 two output steps, |d| <= 8e-3 |ref| + 1e-3 max|ref|."""
        d, r = (out.float() - ref.float()).abs(), ref.float().abs()
        rtol, mtol = (1e-5, 1e-4) if dtype == torch.float32 else (8e-3, 1e-3)
        return float(d.max()), bool((d <= rtol * r + mtol * r.max()).all())

    def bound(r, tag):
        t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = r["flops"] / PEAK_FLOPS[tag] * 1e3
        r["bound_ms"], r["bound_by"] = max(t_bytes, t_ops), (
            "bytes" if t_bytes >= t_ops else "operations")

    def a8_ok(out, ref, dtype):
        """W-A8 kernels on the same int8 input as their plain version: float32
        |d| <= 1e-5 max|ref|, bfloat16 one output step more (see below)."""
        d, r = (out.float() - ref.float()).abs(), ref.float().abs()
        step = 2.0**-7 * r if dtype == torch.bfloat16 else 0.0
        return float(d.max()), bool((d <= step + 1e-5 * r.max()).all())

    def int8_ok(out, ref):
        """int8 epilogue: |d| <= 1 step, on at most 0.5% of the values."""
        d = (out.float() - ref.float()).abs()
        return float(d.max()), bool(d.max() <= 1 and (d > 0).float().mean() <= 0.005)

    def head_split_ok(out, ref, dtype):
        """(max|d|, reading, ok) of the head-split kernel against its plain
        version: float32 reads max|d| <= 1e-4; bfloat16 reads the least c
        with |d| <= 2**-7 |ref| + c max|ref| everywhere, <= HS_BF16_C."""
        d, r = (out.float() - ref.float()).abs(), ref.float().abs()
        if dtype == torch.float32:
            reading = float(d.max())
            return reading, reading, reading <= 1e-4
        reading = float(((d - 2.0**-7 * r) / r.max()).max())
        return float(d.max()), reading, reading <= HS_BF16_C

    def attention_check(name, tag, dtype, out, ref, wrong):
        """A serving attention kernel against its plain version by
        head_split_ok; ``wrong``, the plain version with its last key tile
        left out of p.v, must fail the same bound."""
        err, reading, ok = head_split_ok(out, ref, dtype)
        _, wrong_reading, wrong_ok = head_split_ok(wrong, ref, dtype)
        limit = 1e-4 if dtype == torch.float32 else HS_BF16_C
        check(ok and not wrong_ok and out.dtype == dtype,
              f"{name} {tag}: max|d| {err:.3e} vs plain, reading {reading:.3e} (<= {limit}; "
              f"last tile skipped reads {wrong_reading:.3e})")

    # ------------------------------------------------------------------ kernels
    # ViT-H, B = 1: 25 windows of 14x14 x 16 heads; global 64x64 x 16 heads; hd 80.
    nh, hd, ws, g = 16, 80, 14, 64
    C, NW, Lw, Lg = nh * hd, 25, ws * ws, g * g
    scale = hd**-0.5
    report = {}
    gen.manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        item = 4 if dtype == torch.float32 else 2
        # windowed
        qkv, rel = randn(NW, Lw, 3 * C, dtype=dtype), randn(NW, nh, Lw, 2 * ws, dtype=dtype)
        kw_args = dict(nh=nh, hd=hd, kh=ws, kw=ws)
        ref = fa.flash_windowed_plain(qkv, rel, scale, **kw_args)
        out = fa.flash_attention_qkv_packed(qkv, rel, scale, **kw_args)
        torch.cuda.synchronize()
        skip = qkv.clone()  # the last key tile (L % 64 keys) left out of p.v
        skip[:, Lw - (Lw % 64 or 64):, 2 * C:] = 0
        attention_check("flash_windowed", tag, dtype, out, ref,
                        fa.flash_windowed_plain(skip, rel, scale, **kw_args))
        del skip
        ois = 127.0 / float(ref.float().abs().max())
        out8 = fa.flash_attention_qkv_packed(qkv, rel, scale, out_inv_scale=ois, **kw_args)
        ref8 = fa.flash_windowed_plain(qkv, rel, scale, out_inv_scale=ois, **kw_args)
        err8, ok8 = int8_ok(out8, ref8)
        check(ok8 and out8.dtype == torch.int8, f"flash_windowed {tag} int8: max|d| {err8:.0f}")
        win = dict(
            err=float((out.float() - ref.float()).abs().max()),
            ms=cuda_ms(lambda: fa.flash_attention_qkv_packed(qkv, rel, scale, **kw_args), 20),
            plain_ms=cuda_ms(lambda: fa.flash_windowed_plain(qkv, rel, scale, **kw_args), 5),
            bytes=(NW * Lw * 3 * C + NW * nh * Lw * 2 * ws + NW * Lw * C) * item,
            flops=4 * NW * nh * Lw * Lw * hd,
        )
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(NW, Lw, nh, hd).transpose(1, 2)
                   .contiguous() for i in range(3))
        n = torch.arange(Lw, device=dev)
        mask = (rel[..., n // ws] + rel[..., ws + n % ws]).contiguous()
        win["library_ms"] = cuda_ms(
            lambda: TF.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), 20)
        del qkv, rel, q, k, v, mask, ref, out, ref8, out8
        # global
        q, k, v = (randn(1, nh, Lg, hd, dtype=dtype) for _ in range(3))
        rh, rw = randn(1, nh, Lg, g, dtype=dtype), randn(1, nh, Lg, g, dtype=dtype)
        ref = fa.flash_attention_plain(q, k, v, rh, rw, scale)
        out = fa.flash_attention_relpos(q, k, v, rh, rw, scale)
        torch.cuda.synchronize()
        skip = v.clone()
        skip[..., Lg - 64:, :] = 0
        attention_check("flash_global", tag, dtype, out, ref,
                        fa.flash_attention_plain(q, k, skip, rh, rw, scale))
        del skip
        ois = 127.0 / float(ref.float().abs().max())
        out8 = fa.flash_attention_relpos(q, k, v, rh, rw, scale, out_inv_scale=ois)
        ref8 = fa.flash_attention_plain(q, k, v, rh, rw, scale, out_inv_scale=ois)
        err8, ok8 = int8_ok(out8, ref8)
        check(ok8 and out8.dtype == torch.int8, f"flash_global {tag} int8: max|d| {err8:.0f}")
        glob = dict(
            err=float((out.float() - ref.float()).abs().max()),
            ms=cuda_ms(lambda: fa.flash_attention_relpos(q, k, v, rh, rw, scale), 5),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, rh, rw, scale), 3),
            bytes=(nh * Lg * (3 * hd + 2 * g) + nh * Lg * hd) * item,
            flops=4 * nh * Lg * Lg * hd,
        )
        n = torch.arange(Lg, device=dev)
        mask = (rh[..., n // g] + rw[..., n % g]).contiguous()
        glob["library_ms"] = cuda_ms(
            lambda: TF.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), 5)
        del q, k, v, rh, rw, mask, ref, out, ref8, out8
        for name, r in (("flash_windowed", win), ("flash_global", glob)):
            bound(r, tag)
            print(f"{name} {tag}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"sdpa {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), max|d| {r['err']:.3e}")
            report[(name, tag)] = r
        torch.cuda.empty_cache()

    # ---------------------------------------------------- head-split kernel
    # csrc/flash_attn.cu behind two counters: flash_whole at the ViT-H
    # training shape (25 windows x 16 heads, L 196, rel 14 + 14) and
    # rel-less; flash_rowblock at the rel-less ViT-H global shape (16 heads,
    # L 4096) and at a rel grid the bias3d kernel cannot take (50 x 50, 128
    # % 50 != 0). bfloat16 runs the TMA tensor-core body, float32 the
    # register-tiled CUDA-core one. The first case of each counter is its
    # JSON row (flash_whole's in float32, JSON_DTYPE). Each
    # case also reads a wrong output, the plain version with the last key
    # tile (L % 64 keys, or 64) left out of p.v, and fails if the bound
    # takes it.
    gen.manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        item = 4 if dtype == torch.float32 else 2
        for name, what, B, L, kv in (("flash_whole", "train", NW, Lw, (ws, ws)),
                                     ("flash_whole", "rel-less", NW, Lw, None),
                                     ("flash_rowblock", "rel-less global", 1, Lg, None),
                                     ("flash_rowblock", "50x50", 1, 2500, (50, 50))):
            q, k, v = (randn(B, nh, L, hd, dtype=dtype) for _ in range(3))
            rel = (None, None) if kv is None else tuple(
                randn(B, nh, L, n, dtype=dtype) for n in kv)
            ref = fa.flash_attention_plain(q, k, v, *rel, scale)
            before = counts()
            out = fa.flash_attention_relpos(q, k, v, *rel, scale)
            torch.cuda.synchronize()
            err, reading, ok = head_split_ok(out, ref, dtype)
            launched = {n: c - before[n] for n, c in counts().items() if c != before[n]}
            v_skip = v.clone()
            v_skip[..., L - (L % 64 or 64):, :] = 0
            _, wrong, wrong_ok = head_split_ok(
                fa.flash_attention_plain(q, k, v_skip, *rel, scale), ref, dtype)
            limit = 1e-4 if dtype == torch.float32 else HS_BF16_C
            check(ok and not wrong_ok and out.dtype == dtype and launched == {name: 1},
                  f"{name} {what} {tag}: max|d| {err:.3e} vs plain, reading {reading:.3e} "
                  f"(<= {limit}; last tile skipped reads {wrong:.3e}), launches {launched}")
            del v_skip
            mask = None
            if kv is not None:
                n = torch.arange(L, device=dev)
                mask = (rel[0][..., n // kv[1]] + rel[1][..., n % kv[1]]).contiguous()
            iters = 20 if L <= 512 else 5
            r = dict(
                err=err,
                ms=cuda_ms(lambda: fa.flash_attention_relpos(q, k, v, *rel, scale), iters),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, *rel, scale), 3),
                library_ms=cuda_ms(lambda: TF.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale), iters),
                bytes=B * nh * L * (4 * hd + (sum(kv) if kv else 0)) * item,
                flops=4 * B * nh * L * L * hd,
            )
            bound(r, tag)
            print(f"{name} {what} {tag} (BH {B * nh}, L {L}): kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|d| {r['err']:.3e}")
            report.setdefault((name, tag), r)
            del q, k, v, rel, mask, ref, out
        torch.cuda.empty_cache()

    # ------------------------------------------------- stage-probe kernels
    # bfloat16 at the probes' ViT-H shapes: P1 on the packed qkv of 25
    # windows (16 heads, L 196, hd 80, rel 14 + 14), read in place; P2/P3 on
    # the same heads split and zero-padded to (25, 16, 256, 128), P3 with q
    # prescaled by hd**-0.5 * log2(e) and, after them, on the probe driver's
    # unscaled q (P3_RAW_C); P4/P5 on the 16 global heads (L 4096)
    # padded to 128 lanes, q prescaled the same way, P5 with raw 64 + 64 rel
    # tiles. Each is held to the head-split bound; the plain version with the
    # last key tile (of the real keys) left out of p.v must fail it. The
    # first case of each counter is its JSON row.
    gen.manual_seed(5)
    bf = torch.bfloat16
    qkv = randn(NW, Lw, 3 * C, dtype=bf)
    rel = randn(NW, nh, Lw, 2 * ws, std=0.05, dtype=bf)
    pq, pk, pv = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]

    def split_pad(a, L, Lp, heads, B):
        a = a.reshape(B, L, heads, hd).transpose(1, 2)
        return TF.pad(a, (0, 128 - hd, 0, Lp - L)).reshape(B * heads, Lp, 128).contiguous()

    ws_heads = [split_pad(a, Lw, 256, nh, NW) for a in (pq, pk, pv)]
    p3_heads = [(ws_heads[0].float() * (scale * fa.LOG2E)).to(bf), *ws_heads[1:]]
    gq, gk, gv = (randn(1, Lg, C, dtype=bf) for _ in range(3))
    gq = (gq.float() * (scale * fa.LOG2E)).to(bf)
    g_heads = [split_pad(a, Lg, Lg, nh, 1) for a in (gq, gk, gv)]
    grh, grw = randn(nh, Lg, g, std=0.05, dtype=bf), randn(nh, Lg, g, std=0.05, dtype=bf)
    n_g = torch.arange(Lg, device=dev)
    g_mask = ((grw.float()[..., n_g % g] + grh.float()[..., n_g // g]) * LN2).to(bf)

    def sdpa(qkv_heads, mask=None):
        """SDPA on (B, heads, L, 128): softmax(s ln 2) = the exp2 softmax of s."""
        q4, k4, v4 = qkv_heads
        return lambda: TF.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=LN2)

    def bmm2(q3, k3, v3):
        return lambda: torch.bmm(torch.bmm(q3, k3.transpose(1, 2)), v3)

    heads_w = [t.reshape(NW, nh, 256, 128) for t in p3_heads]
    heads_g = [t.reshape(1, nh, Lg, 128) for t in g_heads]
    probe_cases = [
        # name, what, kernel, plain (on v'), v, real keys, bytes, flops, library
        ("probe_no_softmax", "ViT-H windows",
         lambda v: ps.probe_no_softmax(pq, pk, v, rel, scale, nh=nh, hd=hd),
         lambda v: ps.probe_no_softmax_plain(pq, pk, v, rel, scale, nh=nh, hd=hd), pv, Lw,
         (3 * NW * Lw * C + NW * nh * Lw * 2 * ws + NW * Lw * C) * 2,
         2 * NW * nh * Lw * Lw * (2 * hd + 2 * ws),
         bmm2(*(split_pad(a, Lw, Lw, nh, NW)[..., :hd] for a in (pq, pk, pv)))),
        ("probe_dots_floor", "presplit (400, 256, 128)",
         lambda v: ps.probe_dots_floor(*ws_heads[:2], v),
         lambda v: ps.probe_dots_floor_plain(*ws_heads[:2], v), ws_heads[2], Lw,
         4 * NW * nh * 256 * 128 * 2, 4 * NW * nh * 256 * 256 * 128, bmm2(*ws_heads)),
        ("probe_presplit", "exp2, presplit (400, 256, 128)",
         lambda v: ps.probe_presplit(*p3_heads[:2], v, True),
         lambda v: ps.probe_presplit_plain(*p3_heads[:2], v, True), p3_heads[2], Lw,
         4 * NW * nh * 256 * 128 * 2, 4 * NW * nh * 256 * 256 * 128, sdpa(heads_w)),
        ("probe_presplit", "exp, presplit (400, 256, 128)",
         lambda v: ps.probe_presplit(*p3_heads[:2], v, False),
         lambda v: ps.probe_presplit_plain(*p3_heads[:2], v, False), p3_heads[2], Lw,
         4 * NW * nh * 256 * 128 * 2, 4 * NW * nh * 256 * 256 * 128, sdpa(heads_w)),
        ("probe_pair", "row max, global (16, 4096, 128)",
         lambda v: ps.probe_pair(*g_heads[:2], v, False),
         lambda v: ps.probe_pair_plain(*g_heads[:2], v, False), g_heads[2], Lg,
         4 * nh * Lg * 128 * 2, 4 * nh * Lg * Lg * 128, sdpa(heads_g)),
        ("probe_pair", "clamp 40, global (16, 4096, 128)",
         lambda v: ps.probe_pair(*g_heads[:2], v, True),
         lambda v: ps.probe_pair_plain(*g_heads[:2], v, True), g_heads[2], Lg,
         4 * nh * Lg * 128 * 2, 4 * nh * Lg * Lg * 128, sdpa(heads_g)),
        ("probe_pair_bias", "row max, global + rel 64 x 64",
         lambda v: ps.probe_pair_bias(*g_heads[:2], v, grh, grw, False),
         lambda v: ps.probe_pair_bias_plain(*g_heads[:2], v, grh, grw, False), g_heads[2], Lg,
         (4 * nh * Lg * 128 + 2 * nh * Lg * g) * 2, 4 * nh * Lg * Lg * 128,
         sdpa(heads_g, g_mask[None])),
        ("probe_pair_bias", "clamp 40, global + rel 64 x 64",
         lambda v: ps.probe_pair_bias(*g_heads[:2], v, grh, grw, True),
         lambda v: ps.probe_pair_bias_plain(*g_heads[:2], v, grh, grw, True), g_heads[2], Lg,
         (4 * nh * Lg * 128 + 2 * nh * Lg * g) * 2, 4 * nh * Lg * Lg * 128,
         sdpa(heads_g, g_mask[None])),
    ]
    for name, what, kernel, plain, v, L_real, nbytes, flops, library in probe_cases:
        ref = plain(v)
        before = counts()
        out = kernel(v)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in counts().items() if c != before[n]}
        err, reading, ok = head_split_ok(out, ref, bf)
        v_skip = v.clone()
        v_skip[..., L_real - (L_real % 64 or 64):L_real, :] = 0
        _, wrong, wrong_ok = head_split_ok(plain(v_skip), ref, bf)
        check(ok and not wrong_ok and out.dtype == bf and launched == {name: 1},
              f"{name} {what}: max|d| {err:.3e} vs plain, reading {reading:.3e} "
              f"(<= {HS_BF16_C}; last tile skipped reads {wrong:.3e}), launches {launched}")
        long = L_real == Lg
        iters = 5 if long else 20
        r = dict(err=err, ms=cuda_ms(lambda: kernel(v), iters), plain_ms=cuda_ms(lambda: plain(v), 3),
                 library_ms=cuda_ms(library, iters), bytes=nbytes, flops=flops)
        bound(r, "bfloat16")
        print(f"{name} {what}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"max|d| {r['err']:.3e}")
        report.setdefault((name, "bfloat16"), r)
        del v_skip, ref, out
    # P3 on tools/packed_probe.py's own unscaled q, held to P3_RAW_C against
    # the plain version and to the plain version's own distance from a
    # float64 evaluation of the same function (see P3_RAW_C).
    def presplit_f64(q, k, v, exp2):
        s = torch.matmul(q.double(), k.double().transpose(1, 2))
        x = s - s.amax(-1, keepdim=True)
        p = torch.exp2(x) if exp2 else torch.exp(x)
        o = torch.matmul(p.float().to(bf).double(), v.double())
        return (o / p.sum(-1, keepdim=True)).float().to(bf)

    def reading(out, ref):
        return head_split_ok(out, ref, bf)[1]

    v_skip = ws_heads[2].clone()
    v_skip[..., Lw - (Lw % 64 or 64):Lw, :] = 0
    for exp2 in (True, False):
        before = counts()
        out = ps.probe_presplit(*ws_heads, exp2)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in counts().items() if c != before[n]}
        ref, f64 = ps.probe_presplit_plain(*ws_heads, exp2), presplit_f64(*ws_heads, exp2)
        wrong = ps.probe_presplit_plain(*ws_heads[:2], v_skip, exp2)
        raw, plain_f64, kernel_f64 = reading(out, ref), reading(ref, f64), reading(out, f64)
        f64_limit = max(HS_BF16_C, P3_F64_MARGIN * plain_f64)
        wrong_raw, wrong_f64 = reading(wrong, ref), reading(wrong, f64)
        check(raw <= P3_RAW_C and kernel_f64 <= f64_limit and wrong_raw > P3_RAW_C
              and wrong_f64 > f64_limit and launched == {"probe_presplit": 1},
              f"probe_presplit {'exp2' if exp2 else 'exp'} on unscaled q: reading kernel vs "
              f"plain {raw:.3e} (<= {P3_RAW_C}), kernel vs float64 {kernel_f64:.3e} (<= "
              f"{f64_limit:.3e}; plain vs float64 {plain_f64:.3e}); last tile skipped reads "
              f"{wrong_raw:.3e} / {wrong_f64:.3e}, launches {launched}")
        del out, ref, f64, wrong
    del v_skip
    del probe_cases, qkv, rel, pq, pk, pv, ws_heads, p3_heads, heads_w, g_heads, heads_g, gq, gk
    del gv
    del grh, grw, g_mask
    torch.cuda.empty_cache()

    # ------------------------------------------------------ packed-weight kernels
    # ViT-H, B = 1: qkv/proj on 25 windows x 196 tokens, the MLP on 64 x 64
    # global tokens; RTN 4-bit (3-bit for quant_matmul3) with groups of 128.
    # Each case also reads a wrong output, the plain version with x's last K
    # tile (the kernels' tile_rows of the first product) left out, and fails
    # if the bound takes it.
    Mw, Mg, H = NW * Lw, Lg, 4 * C
    gen.manual_seed(2)

    def rtn(K, N, bits, bias=True):
        return packed_lib.quantize_rtn(randn(K, N, std=K**-0.5), bits, 128,
                                       bias=randn(N, std=0.02) if bias else None)

    qkv4, proj4, qkv3 = rtn(C, 3 * C, 4), rtn(C, C, 4), rtn(C, 3 * C, 3)
    lin1, lin2 = rtn(C, H, 4), rtn(H, C, 4, bias=False)  # b2 is added outside the kernel

    def words(p):
        hi = 0 if p.qweight_hi is None else p.qweight_hi.numel()
        return (p.qweight.numel() + hi + 2 * p.scales.numel()) * 4

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        item = 4 if dtype == torch.float32 else 2
        cases = []
        for name, shape, p in (("quant_matmul", "qkv", qkv4), ("quant_matmul", "proj", proj4),
                               ("quant_matmul3", "qkv", qkv3)):
            x = randn(Mw, C, dtype=dtype)
            wd = packed_lib.dequantize(p).to(dtype)
            cases.append((name, shape, x, (lambda x=x, p=p: qm.quant_matmul(x, p)),
                          (lambda x, p=p: qm.quant_matmul_plain(x, p)),
                          (lambda x=x, wd=wd: torch.matmul(x, wd)),
                          dict(bytes=Mw * (C + p.out_features) * item + words(p),
                               flops=2 * Mw * C * p.out_features), qm.tile_rows(p.pack_block)))
        x = randn(Mg, C, dtype=dtype)
        w1d, w2d = packed_lib.dequantize(lin1).to(dtype), packed_lib.dequantize(lin2).to(dtype)
        b1d = lin1.bias.to(dtype)
        cases.append(("fused_mlp", "mlp", x, (lambda x=x: fm.fused_mlp(x, lin1, lin2)),
                      (lambda x: fm.fused_mlp_plain(x, lin1, lin2)),
                      (lambda x=x: torch.matmul(
                          TF.gelu(torch.addmm(b1d, x, w1d), approximate="tanh"), w2d)),
                      dict(bytes=2 * Mg * C * item + words(lin1) + H * 4 + words(lin2),
                           flops=4 * Mg * C * H), qm.tile_rows(lin1.pack_block)))
        for name, shape, x, kernel, plain, library, r, kt in cases:
            before = counts()
            out = kernel()
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in counts().items() if c != before[n]}
            ref = plain(x)
            r["err"], ok = rel_ok(out, ref, dtype)
            cut = x.clone()
            cut[:, x.shape[1] - kt:] = 0
            wrong_err, wrong_ok = rel_ok(plain(cut), ref, dtype)
            check(ok and not wrong_ok and out.dtype == dtype and launched == {name: 1}
                  and tuple(out.shape) == tuple(ref.shape),
                  f"{name} {shape} {tag}: max|d| {r['err']:.3e} vs plain (last K tile left out: "
                  f"max|d| {wrong_err:.3e}, {'taken' if wrong_ok else 'rejected'}), "
                  f"launches {launched}")
            del cut
            slow = dtype == torch.float32 and name == "fused_mlp"
            r["ms"] = cuda_ms(kernel, 3 if slow else 20)
            r["plain_ms"] = cuda_ms(lambda: plain(x), 3 if slow else 10)
            r["library_ms"] = cuda_ms(library, 3 if slow else 20)
            bound(r, tag)
            print(f"{name} {shape} {tag} (M {x.shape[0]}): kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max|d| {r['err']:.3e}")
            report[(name if shape != "proj" else "quant_matmul proj", tag)] = r
            del out, ref
        del cases, x, w1d, w2d
        torch.cuda.empty_cache()
    del qkv4, proj4, qkv3, lin1, lin2

    # Pack blocks that are not powers of two (default_pack_block's 48 for
    # groups of 48, 96 for groups of 96 at 3 bits), in each of the five
    # packed kernels: K tiles of whole pack blocks (96 rows). M as above, K
    # and H 1536 (multiples of 48, 96 and 512), N 1280; held to the same
    # bounds (the W-A8 kernels to a8_ok, below, on the same int8 input), with
    # the last K tile left out as the wrong output.
    gen.manual_seed(7)
    Ko = 1536
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        for name, bits, g_ in (("quant_matmul", 4, 48), ("quant_matmul3", 3, 96),
                               ("fused_mlp", 4, 48), ("quant_matmul_a8_sym", 4, 48),
                               ("quant_matmul_a8", 4, 48)):
            sym = name == "quant_matmul_a8_sym"
            if name == "fused_mlp":
                x = randn(Mg, Ko, dtype=dtype)
                l1 = packed_lib.quantize_rtn(randn(Ko, Ko, std=Ko**-0.5), bits, g_,
                                             bias=randn(Ko, std=0.02))
                l2 = packed_lib.quantize_rtn(randn(Ko, C, std=Ko**-0.5), bits, g_)
                pbs = {l1.pack_block, l2.pack_block}
                kernel, plain = (lambda: fm.fused_mlp(x, l1, l2)), (
                    lambda x: fm.fused_mlp_plain(x, l1, l2))
                ok_fn, kt = rel_ok, qm.tile_rows(l1.pack_block)
            elif name.startswith("quant_matmul_a8"):
                x = randn(Mw, Ko, dtype=dtype)
                p = packed_lib.with_act_bits(packed_lib.quantize_rtn(
                    randn(Ko, C, std=Ko**-0.5) + (0.0 if sym else 1.5 * Ko**-0.5), bits, g_,
                    sym), 8)
                pbs = {p.pack_block}
                xq, xs = qm.quantize_activations_int8(x)
                kernel = lambda: qm.a8_matmul(xq, xs, p, dtype, sym)  # noqa: E731
                plain = lambda xq_: qm.a8_matmul_plain(xq_, xs, p, dtype, sym)  # noqa: E731
                x, ok_fn, kt = xq, a8_ok, qm.tile_rows(p.pack_block)
            else:
                x = randn(Mw, Ko, dtype=dtype)
                p = packed_lib.quantize_rtn(randn(Ko, C, std=Ko**-0.5), bits, g_)
                pbs = {p.pack_block}
                kernel, plain = (lambda: qm.quant_matmul(x, p)), (
                    lambda x: qm.quant_matmul_plain(x, p))
                ok_fn, kt = rel_ok, qm.tile_rows(p.pack_block)
            before = counts()
            out = kernel()
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in counts().items() if c != before[n]}
            ref = plain(x)
            err, ok = ok_fn(out, ref, dtype)
            cut = x.clone()
            cut[:, Ko - kt:] = 0
            wrong_err, wrong_ok = ok_fn(plain(cut), ref, dtype)
            check(ok and not wrong_ok and launched == {name: 1} and pbs == {g_}
                  and out.dtype == dtype and kt == 96,
                  f"{name} W{bits} pack block {sorted(pbs)} (K tile {kt}) {tag}: max|d| "
                  f"{err:.3e} vs plain (last K tile left out: max|d| {wrong_err:.3e}, "
                  f"{'taken' if wrong_ok else 'rejected'}), launches {launched}")
            del x, out, ref, cut
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ W-A8 kernels
    # ViT-H, B = 1, RTN groups of 128 with int8 activations: qkv/proj on the
    # 4900 windowed tokens, lin1/lin2 on the 4096 global ones, 4-bit, both
    # kernels; also 2- and 8-bit symmetric and 8-bit asymmetric (off = 128)
    # at the qkv shape. The asymmetric weights are skewed, so the zero points
    # sit far from the middle. Each kernel and its plain version take the same
    # int8 input: the integer sums are exact on both sides and the float32
    # epilogue runs in the same order, so float32 |d| <= 1e-5 max|ref| and
    # bfloat16 one output step, |d| <= 2**-7 |ref| + 1e-5 max|ref|; the plain
    # version with x's last K tile left out must fail that bound.
    gen.manual_seed(3)
    a8_shapes = (("qkv", Mw, C, 3 * C), ("proj", Mw, C, C), ("lin1", Mg, C, H), ("lin2", Mg, H, C))
    a8_cases = [(sym, 4, *shape) for sym in (True, False) for shape in a8_shapes]
    a8_cases += [(True, 2, *a8_shapes[0]), (True, 8, *a8_shapes[0]), (False, 8, *a8_shapes[0])]

    for sym, bits, shape, M, K, N in a8_cases:
        name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
        std = K**-0.5
        p = packed_lib.quantize_rtn(randn(K, N, std=std) + (0.0 if sym else 1.5 * std), bits, 128,
                                    sym)
        w8 = (packed_lib.unpack_to_int(p) - qm.a8_offset(bits, sym)).to(torch.int8)
        w8 = w8.t().contiguous().t()  # column-major: cuBLAS's preferred int8 layout
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[1]
            item = 4 if dtype == torch.float32 else 2
            x = randn(M, K, dtype=dtype)
            xq, xs = qm.quantize_activations_int8(x)
            out = qm.a8_matmul(xq, xs, p, dtype, sym)
            ref = qm.a8_matmul_plain(xq, xs, p, dtype, sym)
            torch.cuda.synchronize()
            r = dict(bytes=M * K + 4 * M + 4 * p.qweight.numel()
                     + 4 * p.scales.numel() * (1 if sym else 2) + M * N * item,
                     flops=2 * M * K * N)
            r["err"], ok = a8_ok(out, ref, dtype)
            cut = xq.clone()
            cut[:, K - qm.tile_rows(p.pack_block):] = 0
            wrong_err, wrong_ok = a8_ok(qm.a8_matmul_plain(cut, xs, p, dtype, sym), ref, dtype)
            check(ok and not wrong_ok and out.dtype == dtype and tuple(out.shape) == (M, N),
                  f"{name} W{bits} {shape} {tag}: max|d| {r['err']:.3e} vs plain (last K tile "
                  f"left out: max|d| {wrong_err:.3e}, {'taken' if wrong_ok else 'rejected'})")
            del cut
            r["ms"] = cuda_ms(lambda: qm.a8_matmul(xq, xs, p, dtype, sym), 20)
            r["plain_ms"] = cuda_ms(lambda: qm.a8_matmul_plain(xq, xs, p, dtype, sym), 3)
            r["library_ms"] = cuda_ms(lambda: torch._int_mm(xq, w8), 20)
            r["quantize_ms"] = cuda_ms(lambda: qm.quantize_activations_int8(x), 20)
            bound(r, "int8")
            print(f"{name} W{bits} {shape} {tag} (M {M}, K {K}, N {N}): kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, _int_mm {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), quantize pass "
                  f"{r['quantize_ms']:.4f} ms, max|d| {r['err']:.3e}")
            if bits == 4 and shape == "qkv":
                report[(name, tag)] = r
            del x, xq, xs, out, ref
        del p, w8
    torch.cuda.empty_cache()

    # Every float32 build beside its library call and bound (the JSON line
    # carries the bfloat16 rows, and flash_whole's float32 one).
    for (name, tag), r in report.items():
        if tag == "float32":
            print(f"float32 {name}: kernel {r['ms']:.4f} ms, library {r['library_ms']:.4f} ms "
                  f"(x lib {r['ms'] / r['library_ms']:.2f}), bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms  [{card}]")

    # --------------------------------------------------------------- main path
    def vit_h():
        """ViT-H from seed 0 with rel-pos tables drawn from seed 1."""
        model = build_sam.sam_model_registry["vit_h"](device="cuda", seed=0)
        gen.manual_seed(1)
        for blk in model.image_encoder.blocks:
            blk.attn.rel_pos_h.copy_(randn(*blk.attn.rel_pos_h.shape, std=0.2))
            blk.attn.rel_pos_w.copy_(randn(*blk.attn.rel_pos_w.shape, std=0.2))
        return model

    model = vit_h()
    x = randn(1, 1024, 1024, 3)
    flash_launches = {**zero, "flash_windowed": 28, "flash_global": 4}  # per ViT-H image
    with torch.no_grad():
        embs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[1]
            model.image_encoder.to(dtype)
            for impl in ("kernel", "eager"):
                reset_counts()
                embs[tag, impl] = sam_lib.encode_image(model, x.to(dtype), impl).float()
                torch.cuda.synchronize()
                want = flash_launches if impl == "kernel" else zero
                check(counts() == want, f"encode {tag} {impl}: launches {counts()}")
            e = embs[tag, "kernel"]
            check(tuple(e.shape) == (1, 64, 64, 256) and bool(torch.isfinite(e).all()),
                  f"encode {tag}: shape {tuple(e.shape)}, finite")
        ref = embs["float32", "eager"]
        for tag, impl, tol in (("float32", "kernel", 1e-3), ("bfloat16", "kernel", 5e-2),
                               ("bfloat16", "eager", 5e-2)):
            rel_err = float((embs[tag, impl] - ref).norm() / ref.norm())
            check(rel_err <= tol, f"encode {tag} {impl} vs float32 eager: "
                                  f"rel L2 {rel_err:.3e} (<= {tol})")
        del embs

        # Served as bfloat16, like the JAX package's serving benchmark: the
        # encoder runs in its weights' dtype, as README's example sets it.
        model.image_encoder.to(torch.bfloat16)
        rng = np.random.default_rng(0)
        images = [rng.integers(0, 256, (1200, 1600, 3), dtype=np.uint8)
                  for _ in range(SERVED_IMAGES)]
        clicks = [(np.array([[800.0, 600.0]]), np.array([1.0])),
                  (np.array([[800.0, 600.0], [300.0, 900.0]]), np.array([1.0, 0.0])),
                  (np.array([[800.0, 600.0], [300.0, 900.0], [1200.0, 200.0]]),
                   np.array([1.0, 0.0, 1.0]))]

        def serve(predictor, image):
            """set_image + the clicks; returns the wall ms of each and the outputs."""
            torch.cuda.synchronize()
            t = time.perf_counter()
            predictor.set_image(image)
            torch.cuda.synchronize()
            times, outs, prev = [(time.perf_counter() - t) * 1e3], [], None
            for pts, labels in clicks:
                t = time.perf_counter()
                res = predictor.predict(pts, labels, mask_input=prev,
                                        multimask_output=prev is None)
                times.append((time.perf_counter() - t) * 1e3)
                outs.append(res)
                masks, iou, low = res
                prev = low[int(np.argmax(iou))][None]
            return times, outs

        def serve_all(what, want):
            """Serve every image; check the launches of one and the outputs."""
            predictor = SamPredictor(model)
            serve(predictor, images[-1])  # warm-up: first-call allocations and library set-up
            reset_counts()
            times, outs = serve(predictor, images[0])
            launches = counts()
            check(launches == want, f"{what} served image: launches {launches}")
            for i, (masks, iou, low) in enumerate(outs):
                nm = 3 if i == 0 else 1
                check(masks.shape == (nm, 1200, 1600) and masks.dtype == np.bool_
                      and iou.shape == (nm,) and low.shape == (nm, 256, 256)
                      and np.isfinite(iou).all() and np.isfinite(low).all(),
                      f"{what} click {i + 1}: masks {masks.shape}, iou {iou.shape}, "
                      f"low {low.shape}, finite")
            all_times = [times] + [serve(predictor, im)[0] for im in images[1:]]
            steps = ["set_image"] + [f"click {i + 1}" for i in range(len(clicks))]
            for j, step in enumerate(steps):
                ms = sorted(t[j] for t in all_times)
                print(f"{what} {step}: median {ms[len(ms) // 2]:.2f} ms, min {ms[0]:.2f}, "
                      f"max {ms[-1]:.2f} over {len(ms)} served images  [{card}]")
            return predictor, launches

        predictor, _ = serve_all("dense", flash_launches)
        print_device_profile("dense set_image", lambda: predictor.set_image(images[0]))
        print_device_profile("dense click", lambda: predictor.predict(*clicks[0]))
        del predictor, model
        torch.cuda.empty_cache()

        # W4: the same ViT-H, RTN 4-bit, groups of 128, quantized by the port.
        model = vit_h()
        dense_encoder = copy.deepcopy(model.image_encoder)  # for the W3 encode
        seq.rtn_quantize_encoder(model.image_encoder, seq.GPTQConfig(bits=4, groupsize=128))
        reference = packed_lib.dense_copy(model.image_encoder)  # float32, dequantized weights
        ref = reference(x, "eager").float()
        del reference
        w4_launches = {**flash_launches, "quant_matmul": 64, "fused_mlp": 32}
        qkv = model.image_encoder.blocks[0].attn.qkv
        float_buffers = {k: getattr(qkv, k).clone() for k in ("scales", "zeros", "bias")}
        for dtype, tol in ((torch.float32, W4_F32_TOL), (torch.bfloat16, BF16_TOL)):
            tag = str(dtype).split(".")[1]
            model.image_encoder.to(dtype)
            check(all(getattr(qkv, k).dtype == torch.float32 and torch.equal(getattr(qkv, k), t)
                      for k, t in float_buffers.items()),
                  f"W4 {tag}: scales, zeros, bias unchanged float32 "
                  f"({qkv.scales.dtype}, {qkv.zeros.dtype}, {qkv.bias.dtype})")
            reset_counts()
            e = sam_lib.encode_image(model, x.to(dtype), "kernel").float()
            torch.cuda.synchronize()
            check(counts() == w4_launches, f"W4 encode {tag}: launches {counts()}")
            rel_err = float((e - ref).norm() / ref.norm())
            check(tuple(e.shape) == (1, 64, 64, 256) and bool(torch.isfinite(e).all())
                  and rel_err <= tol, f"W4 encode {tag} vs dequantized dense float32 eager: "
                                      f"rel L2 {rel_err:.3e} (<= {tol})")
        predictor, launches = serve_all("W4", w4_launches)
        print_device_profile("W4 set_image", lambda: predictor.set_image(images[0]))
        del predictor
        torch.cuda.empty_cache()

        # W3: split-plane 3-bit never fuses, so all four linears of a block
        # run quant_matmul3.
        model.image_encoder = dense_encoder
        seq.rtn_quantize_encoder(model.image_encoder, seq.GPTQConfig(bits=3, groupsize=128))
        ref = packed_lib.dense_copy(model.image_encoder)(x, "eager").float()
        model.image_encoder.to(torch.bfloat16)
        reset_counts()
        e = sam_lib.encode_image(model, x.to(torch.bfloat16), "kernel").float()
        torch.cuda.synchronize()
        w3_launches = counts()
        check(w3_launches == {**flash_launches, "quant_matmul3": 128},
              f"W3 encode bfloat16: launches {w3_launches}")
        rel_err = float((e - ref).norm() / ref.norm())
        check(bool(torch.isfinite(e).all()) and rel_err <= BF16_TOL,
              f"W3 encode bfloat16 vs dequantized dense float32 eager: rel L2 {rel_err:.3e} "
              f"(<= {BF16_TOL})")
        launches["quant_matmul3"] = w3_launches["quant_matmul3"]
        del model, dense_encoder, ref, e
        torch.cuda.empty_cache()

        # W4A8 (bench.py --a8): the same ViT-H, RTN symmetric 4-bit, groups of
        # 128, int8 activations on every block linear. No MLP fuses, so all
        # four linears of a block run quant_matmul_a8_sym.
        model = vit_h()
        dense_encoder = copy.deepcopy(model.image_encoder)  # for the asymmetric encode
        seq.rtn_quantize_encoder(model.image_encoder,
                                 seq.GPTQConfig(bits=4, groupsize=128, sym=True))
        model.image_encoder = packed_lib.with_act_bits(model.image_encoder, 8)
        ref = packed_lib.dense_copy(model.image_encoder)(x, "eager").float()
        a8_launches = {**flash_launches, "quant_matmul_a8_sym": 128}
        for dtype, tol in ((torch.float32, A8_F32_TOL), (torch.bfloat16, A8_BF16_TOL)):
            tag = str(dtype).split(".")[1]
            model.image_encoder.to(dtype)
            reset_counts()
            e = sam_lib.encode_image(model, x.to(dtype), "kernel").float()
            torch.cuda.synchronize()
            check(counts() == a8_launches, f"W4A8 encode {tag}: launches {counts()}")
            rel_err = float((e - ref).norm() / ref.norm())
            check(tuple(e.shape) == (1, 64, 64, 256) and bool(torch.isfinite(e).all())
                  and rel_err <= tol, f"W4A8 encode {tag} vs dequantized dense float32 eager: "
                                      f"rel L2 {rel_err:.3e} (<= {tol})")
        predictor, a8_served = serve_all("W4A8", a8_launches)
        launches["quant_matmul_a8_sym"] = a8_served["quant_matmul_a8_sym"]
        print_device_profile("W4A8 set_image", lambda: predictor.set_image(images[0]),
                             ranges=[(qm, "quantize_activations_int8", QUANT_RANGE)])
        del predictor, model
        torch.cuda.empty_cache()

        # Asymmetric W4A8: the zero-point kernel on every block linear.
        encoder = seq.rtn_quantize_encoder(dense_encoder,
                                           seq.GPTQConfig(bits=4, groupsize=128, sym=False))
        encoder = packed_lib.with_act_bits(encoder, 8)
        ref = packed_lib.dense_copy(encoder)(x, "eager").float()
        encoder.to(torch.bfloat16)
        reset_counts()
        e = encoder(x.to(torch.bfloat16), "kernel").float()
        torch.cuda.synchronize()
        asym_launches = counts()
        check(asym_launches == {**flash_launches, "quant_matmul_a8": 128},
              f"W4A8 asymmetric encode bfloat16: launches {asym_launches}")
        launches["quant_matmul_a8"] = asym_launches["quant_matmul_a8"]
        rel_err = float((e - ref).norm() / ref.norm())
        check(bool(torch.isfinite(e).all()) and rel_err <= A8_BF16_TOL,
              f"W4A8 asymmetric encode bfloat16 vs dequantized dense float32 eager: "
              f"rel L2 {rel_err:.3e} (<= {A8_BF16_TOL})")
        del encoder, dense_encoder, ref, e
        torch.cuda.empty_cache()

        # Small input: a vit_tiny predictor on the card against the same weights on the CPU.
        tiny_cpu = build_sam.sam_model_registry["vit_tiny"](device="cpu", seed=3)
        gen_cpu = torch.Generator().manual_seed(4)
        for blk in tiny_cpu.image_encoder.blocks:
            for t in (blk.attn.rel_pos_h, blk.attn.rel_pos_w):
                t.copy_(torch.randn(t.shape, generator=gen_cpu) * 0.5)
        small = rng.integers(0, 256, (150, 200, 3), dtype=np.uint8)
        dense_tiny = tiny_cpu.image_encoder
        for what, qcfg, tol in (("dense", None, 1e-3), ("W4", seq.GPTQConfig(4, 32), 1e-3),
                                ("W4A8", seq.GPTQConfig(4, 32, sym=True), A8_TINY_TOL)):
            if qcfg is not None:
                enc = seq.rtn_quantize_encoder(copy.deepcopy(dense_tiny), qcfg)
                tiny_cpu.image_encoder = packed_lib.with_act_bits(enc, 8 * (what == "W4A8"))
            tiny_gpu = copy.deepcopy(tiny_cpu).to(dev)
            res = []
            for m in (tiny_cpu, tiny_gpu):
                p = SamPredictor(m)
                p.set_image(small)
                res.append(p.predict(np.array([[90.0, 70.0]]), np.array([1.0])))
            d_low = float(np.abs(res[0][2] - res[1][2]).max())
            d_iou = float(np.abs(res[0][1] - res[1][1]).max())
            check(d_low <= tol and d_iou <= tol,
                  f"vit_tiny {what} predictor, card vs CPU: low-res max|d| {d_low:.2e}, "
                  f"iou {d_iou:.2e} (<= {tol})")
        del tiny_cpu, tiny_gpu, dense_tiny

        # Rel-less ViT-H (use_rel_pos=False): JAX's kernel branch sends the
        # 28 windowed blocks to the whole-problem route and the 4 global
        # blocks (L 4096) to the row-block route.
        cfg = configs.VIT_H
        cfg = dataclasses.replace(
            cfg, image_encoder=dataclasses.replace(cfg.image_encoder, use_rel_pos=False))
        encoder = sam_lib.init(cfg, 0, dev).image_encoder
        norel_launches = {**zero, "flash_whole": 28, "flash_rowblock": 4}
        embs = {}
        for dtype, impl in ((torch.float32, "eager"), (torch.float32, "kernel"),
                            (torch.bfloat16, "kernel")):
            tag = str(dtype).split(".")[1]
            encoder.to(dtype)
            reset_counts()
            embs[tag, impl] = encoder(x.to(dtype), impl).float()
            torch.cuda.synchronize()
            got = counts()
            check(got == (norel_launches if impl == "kernel" else zero),
                  f"rel-less encode {tag} {impl}: launches {got}")
        launches["flash_rowblock"] = got["flash_rowblock"]
        ref = embs["float32", "eager"]
        for tag, tol in (("float32", 1e-3), ("bfloat16", BF16_TOL)):
            e = embs[tag, "kernel"]
            rel_err = float((e - ref).norm() / ref.norm())
            check(tuple(e.shape) == (1, 64, 64, 256) and bool(torch.isfinite(e).all())
                  and rel_err <= tol, f"rel-less encode {tag} kernel vs float32 eager: "
                                      f"rel L2 {rel_err:.3e} (<= {tol})")
        del encoder, embs, ref, e
        torch.cuda.empty_cache()

        # Cached int8 (bench.py's default mode, cli.infer --serve-int8): RTN
        # symmetric 4-bit, groups of 128, static activation scales calibrated
        # on the bf16 dense model with one seeded image and margin 1.1 (as
        # bench.py calibrates), cache_int8 with default_serve_skip(1280) = ():
        # every block linear is an IntLinear, and each proj takes its
        # attention kernel's int8 output (int8-pre) in bfloat16.
        model = vit_h()
        calib = copy.deepcopy(model.image_encoder).to(torch.bfloat16)
        gen.manual_seed(6)
        t = time.perf_counter()
        act = act_lib.calibrate_act_scales(
            calib, [randn(1, 1024, 1024, 3, dtype=torch.bfloat16)], margin=1.1)
        print(f"cached int8: {len(act)} static scales calibrated in "
              f"{time.perf_counter() - t:.1f} s (amax x 1.1 from {min(act.values()):.3f} "
              f"to {max(act.values()):.3f})")
        del calib
        seq.rtn_quantize_encoder(model.image_encoder,
                                 seq.GPTQConfig(bits=4, groupsize=128, sym=True))
        ref = packed_lib.dense_copy(model.image_encoder)(x, "eager").float()
        packed_lib.cache_int8(model.image_encoder, act_scales=act,
                              skip=packed_lib.default_serve_skip(C))
        kinds = {type(getattr(getattr(b, o), n)).__name__
                 for b in model.image_encoder.blocks for o, n in BLOCK_LINEARS}
        check(kinds == {"IntLinear"}, f"cached int8: block linears are {kinds}")
        int8_launches = {**flash_launches, "int8_matmul": 96, "int8_matmul_pre": 32,
                         "flash_windowed int8-out": 28, "flash_global int8-out": 4}
        for dtype, tol, want in (
                (torch.float32, INT8_F32_TOL, {**flash_launches, "int8_matmul": 128}),
                (torch.bfloat16, INT8_BF16_TOL, int8_launches)):
            tag = str(dtype).split(".")[1]
            model.image_encoder.to(dtype)
            blocks = model.image_encoder.blocks
            block_in = {}  # the inputs of one windowed and one global block
            hooks = [blocks[i].register_forward_pre_hook(
                lambda m, a, i=i: block_in.__setitem__(i, a[0].clone())) for i in INT8_BLOCKS]
            reset_counts()
            e = sam_lib.encode_image(model, x.to(dtype), "kernel").float()
            torch.cuda.synchronize()
            check(counts() == want, f"cached int8 encode {tag}: launches {counts()}")
            for hook in hooks:
                hook.remove()
            rel_err = float((e - ref).norm() / ref.norm())
            check(tuple(e.shape) == (1, 64, 64, 256) and bool(torch.isfinite(e).all())
                  and rel_err <= tol, f"cached int8 encode {tag} vs dequantized dense float32 "
                                      f"eager: rel L2 {rel_err:.3e} (<= {tol})")
            # The same int8 model on its eager branch: the same int8 weights
            # and static scales, so only the attention and proj's input
            # quantization differ.
            reset_counts()
            eager = sam_lib.encode_image(model, x.to(dtype), "eager").float()
            torch.cuda.synchronize()
            check(counts() == {**zero, "int8_matmul": 128},
                  f"cached int8 encode {tag} eager: launches {counts()}")
            rel_err = float((e - eager).norm() / eager.norm())
            tol = INT8_KERNEL_TOL[tag]
            check(rel_err <= tol, f"cached int8 encode {tag} kernel vs the same model's eager "
                                  f"branch: rel L2 {rel_err:.3e} (<= {tol})")
            # One block at a time on the same input, kernel against eager:
            # the residual update of one block's flips, with no cascade.
            for i in INT8_BLOCKS:
                h, kind = block_in[i], "flash_windowed" if i == 0 else "flash_global"
                reset_counts()
                upd = blocks[i](h, "kernel").float() - h.float()
                torch.cuda.synchronize()
                pre = int(dtype == torch.bfloat16)
                want_blk = {**zero, kind: 1, f"{kind} int8-out": pre,
                            "int8_matmul": 4 - pre, "int8_matmul_pre": pre}
                check(counts() == want_blk, f"cached int8 block {i} {tag} kernel: launches "
                                            f"{ {k: n for k, n in counts().items() if n} }")
                ref_upd = blocks[i](h, "eager").float() - h.float()
                rel_err = float((upd - ref_upd).norm() / ref_upd.norm())
                tol = INT8_BLOCK_TOL[tag]
                check(rel_err <= tol, f"cached int8 block {i} ({kind}) {tag} kernel vs eager: "
                                      f"rel L2 of its update {rel_err:.3e} (<= {tol})")
            del eager, block_in, h, upd, ref_upd
        predictor, _ = serve_all("cached int8", int8_launches)
        parts = print_device_profile(
            "cached int8 set_image", lambda: predictor.set_image(images[0]),
            ranges=[(nn_fn, "quant_linear", "int8 linears"),
                    (qm, "quantize_static", "int8 quantize passes"),
                    (qm, "_int_mm", "int8 products")])
        products, quantize = parts["int8 products"], parts["int8 quantize passes"]
        print(f"cached int8 set_image by part: int8 products {products:.2f} ms, quantize passes "
              f"{quantize:.2f} ms, epilogue passes (scale, cast, bias, copies) "
              f"{parts['int8 linears'] - products - quantize:.2f} ms, attention kernels "
              f"{parts['attention kernels']:.2f} ms  [{card}]")
        del predictor, model, ref, e
        torch.cuda.empty_cache()

        # The stage probes at ViT-H: the path of the five probe kernels.
        reset_counts()
        t = time.perf_counter()
        for driver in (packed_probe, global_stage_probe):
            rc = driver.main(["--model", "vit_h", "--iters", str(PROBE_ITERS)])
            check(rc == 0, f"{driver.__name__} --model vit_h --iters {PROBE_ITERS}: exit {rc}")
        got = counts()
        print(f"probe drivers: {time.perf_counter() - t:.1f} s")
        probe_got = {name: got[name] for name in ps.LAUNCHES}
        check(probe_got == PROBE_LAUNCHES,
              f"probe drivers: probe launches {probe_got} (want {PROBE_LAUNCHES})")
        for name in ps.LAUNCHES:
            launches[name] = got[name]
        torch.cuda.empty_cache()

        # ------------------------------------------------------- click loop
        # (a) The main-path gate through the kernels: vit_tiny_synth (best)
        # in float32 on the card, the scenes of tools/cross_validate_harness.py
        # (synthetic_samples(24, 128, seed=9999), normalised once in numpy).
        phase_t = time.perf_counter()
        lib = native.get_lib()
        check(lib is not None, f"host runtime (csrc/host_runtime.cpp) built and loaded: "
                               f"{native.library_path().name}")
        repo = pathlib.Path(__file__).resolve().parent
        crossval = json.loads((repo / "CROSSVAL.json").read_text())
        tiny = build_sam.sam_model_registry["vit_tiny"](device="cuda")
        ckpt_lib.load_weights(str(repo / "checkpoints" / "vit_tiny_synth"), tiny, "best")

        def normalised(model, scenes):
            mean = np.asarray(model.config.pixel_mean, np.float32)
            std = np.asarray(model.config.pixel_std, np.float32)
            return [(((img - mean) / std).astype(np.float32), gt) for img, gt in scenes]

        scenes = normalised(tiny, synthetic_samples(GATE_SCENES, 128, seed=9999))
        reset_counts()
        t = time.perf_counter()
        res = click_eval.click_loop_eval(*click_eval.make_sam_backend(tiny), scenes,
                                         num_clicks=GATE_CLICKS, img_size=128, seed=GATE_SEED)
        gate_s = time.perf_counter() - t
        got, want = counts(), crossval["jax_mean_ious"]
        gap = max(abs(a - b) for a, b in zip(res.mean_ious, want))
        print("click loop vit_tiny_synth on the card: " + " / ".join(f"{v:.5f}" for v in
              res.mean_ious) + "; CROSSVAL.json jax_mean_ious: " + " / ".join(map(str, want)))
        check(len(res.mean_ious) == len(want) and gap <= GATE_TOL,
              f"main-path gate: {GATE_SCENES} scenes x {GATE_CLICKS} clicks, max gap {gap:.2e} "
              f"(<= {GATE_TOL}), {gate_s:.2f} s")
        want_launches = {**zero, **{k: n * GATE_SCENES for k, n in TINY_LAUNCHES.items()}}
        check(got == want_launches, f"main-path gate: launches "
                                    f"{ {k: n for k, n in got.items() if n} }")
        del tiny, scenes

        # (b) The same loop at full width: seeded ViT-H, bf16 encoder, dense,
        # on 1024 scenes. The IoUs of random weights mean nothing; each click
        # must land in the error region of the mask before it.
        model = vit_h()
        model.image_encoder.to(torch.bfloat16)
        scenes = normalised(model, synthetic_samples(EVAL_SCENES, 1024, seed=11))
        encode, decode = click_eval.make_sam_backend(model)
        encode_ms, click_ms = [], []

        def timed(fn, sink):
            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                sink.append((time.perf_counter() - t) * 1e3)
                return out
            return run

        click_eval.click_loop_eval(encode, decode, scenes[:1], num_clicks=1, img_size=1024)  # warm-up
        reset_counts()
        click_eval.click_loop_eval(encode, decode, scenes[:1], num_clicks=EVAL_CLICKS, img_size=1024)
        got = counts()
        check(got == flash_launches, f"ViT-H click loop, one scene: launches "
                                     f"{ {k: n for k, n in got.items() if n} }")
        res = click_eval.click_loop_eval(timed(encode, encode_ms), timed(decode, click_ms), scenes,
                                         num_clicks=EVAL_CLICKS, img_size=1024,
                                         record_low_res=True)
        ious = np.asarray(res.per_sample_ious)
        in_error = []
        for (_, gt), clicks, lows in zip(scenes, res.clicks, res.low_res):
            prev = np.zeros(gt.shape, bool)
            for (y, x, label), low in zip(clicks, lows):
                error = (gt > 0) & ~prev if label == 1 else ~(gt > 0) & prev
                in_error.append(bool(error[y, x]) or not error.any())
                up = sam_lib.resize_bilinear(torch.from_numpy(low).to(dev), (1024, 1024))
                prev = (up[0, 0] > 0).cpu().numpy()
        check(ious.shape == (EVAL_SCENES, EVAL_CLICKS) and bool(((ious >= 0) & (ious <= 1)).all())
              and all(in_error),
              f"ViT-H bf16 click loop: {EVAL_SCENES} scenes x {EVAL_CLICKS} clicks, IoUs in "
              f"[0, 1] ({ious.min():.3f} to {ious.max():.3f}), {sum(in_error)}/{len(in_error)} "
              f"clicks in the error region")
        for what, ms in (("encode (the loop's set_image)", encode_ms),
                         ("click (decode + upsample)", click_ms)):
            ms = sorted(ms)
            print(f"ViT-H bf16 click loop {what}: median {ms[len(ms) // 2]:.2f} ms, min "
                  f"{ms[0]:.2f}, max {ms[-1]:.2f} over {len(ms)}; {res.seconds_per_image:.3f} s "
                  f"per scene  [{card}]")
        noc, over, spc = click_eval.noc_eval(encode, decode, scenes, max_clicks=NOC_CLICKS,
                                             img_size=1024)
        check(all(1 <= v <= NOC_CLICKS + 1 for v in noc) and all(0 <= v <= EVAL_SCENES for v in over),
              f"ViT-H bf16 noc_eval, max {NOC_CLICKS} clicks: NoC@80/85/90 {noc}, over {over}, "
              f"{spc:.3f} s per scene")

        # (c) One flip-TTA predictor on one ViT-H scene: set_image of the
        # image, then of its mirror at every click.
        image, gt = next(synthetic_samples(1, 1024, seed=11))
        eval_pred = SamEvalPredictor(SamPredictor(model), with_flip=True)
        reset_counts()
        eval_pred.set_input_image(image[0].astype(np.uint8))
        clicker, pred = Clicker(gt_mask=gt), np.zeros(gt.shape, bool)
        for _ in range(2):
            clicker.make_next_click(pred)
            prob = eval_pred.get_prediction(clicker)
            pred = prob > 0.5
        got = counts()
        check(prob.shape == gt.shape and bool(np.isfinite(prob).all())
              and bool(((prob >= 0) & (prob <= 1)).all())
              and got == {k: 3 * n for k, n in flash_launches.items()},
              f"ViT-H bf16 flip-TTA predictor, 2 clicks: probabilities in [0, 1], launches "
              f"{ {k: n for k, n in got.items() if n} } (3 set_image)")
        del model, eval_pred, encode, decode
        torch.cuda.empty_cache()
        print(f"click-loop phase: {time.perf_counter() - phase_t:.1f} s")

    # ----------------------------------------------------------------- training
    # ViT-H fine-tuning in float32 on seeded easy scenes at 1024, batch 1,
    # TrainConfig defaults (11 clicks): the windowed blocks' attention is the
    # head-split kernel forward (28 flash_whole launches a step), the global
    # blocks and every backward are eager.
    model = vit_h()
    trainer_lib.trainable_parameters(model)
    scenes = synthetic_samples(TRAIN_STEPS + 1, 1024, 0)
    batches = [(torch.from_numpy(im).to(dev), torch.from_numpy(gt[None].astype(np.float32)).to(dev))
               for im, gt in scenes]
    train_launches = {**zero, "flash_whole": 28}

    # (a) One click: the click then depends only on the generator and the
    # ground truth, so flash_train and eager see the same prompt.
    grads, losses = {}, {}
    for impl in ("flash_train", "eager"):
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss, _ = trainer_lib.click_train_loss(
            model, *batches[0], torch.Generator(device=dev).manual_seed(5),
            trainer_lib.TrainConfig(num_clicks=1), impl)
        loss.backward()
        torch.cuda.synchronize()
        got = counts()
        check(got == (train_launches if impl == "flash_train" else zero),
              f"one-click loss {impl}: launches {got}")
        losses[impl] = float(loss.detach())
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    # Per-leaf rel. L2 of the flash_train gradient against eager's, with a
    # floor of GRAD_FLOOR x the whole gradient's norm under each leaf's norm:
    # some leaves' exact gradient is zero (a key bias shifts every logit of
    # a row alike, and softmax ignores that), so eager leaves them float32
    # noise, and the noise of two runs differs by its own size.
    total = math.sqrt(sum(float(b.norm()) ** 2 for b in grads["eager"].values()
                          if b is not None))
    errs, zeros_agree = [], True
    for n, b in grads["eager"].items():
        a = grads["flash_train"][n]
        if b is None or not bool(b.any()):
            zeros_agree &= a is None or not bool(a.any())
            continue
        errs.append((float((a - b).norm()) / max(float(b.norm()), GRAD_FLOOR * total), n))
    errs.sort(reverse=True)
    worst = errs[0][0]
    whole = math.sqrt(sum(float((grads["flash_train"][n] - b).norm()) ** 2
                          for n, b in grads["eager"].items() if b is not None)) / total
    loss_err = abs(losses["flash_train"] - losses["eager"]) / abs(losses["eager"])
    check(loss_err <= TRAIN_LOSS_TOL and whole <= TRAIN_GRAD_TOL and worst <= TRAIN_LEAF_TOL
          and zeros_agree,
          f"one-click flash_train vs eager: loss {losses['flash_train']:.7f} vs "
          f"{losses['eager']:.7f} (rel {loss_err:.2e} <= {TRAIN_LOSS_TOL}); gradient rel L2 "
          f"{whole:.3e} over all leaves (<= {TRAIN_GRAD_TOL}), worst leaf {worst:.3e} "
          f"(<= {TRAIN_LEAF_TOL}), zero gradients agree {zeros_agree}")
    print("  worst leaves: " + ", ".join(f"{n} {e:.2e}" for e, n in errs[:4]))
    del grads

    # (b) Steps with 11 clicks and AdamW.
    tcfg = trainer_lib.TrainConfig()
    optimizer = trainer_lib.make_optimizer(tcfg, model)
    step = trainer_lib.make_train_step(tcfg, optimizer)
    gen_train = torch.Generator(device=dev).manual_seed(6)
    watched = {n: p.detach().clone() for n, p in model.named_parameters() if n in TRAIN_WATCH}
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i, (img, gt) in enumerate(batches[:TRAIN_STEPS]):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        aux = step(model, img, gt, gen_train)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        got = counts()
        if i == 0:  # the JSON row counts one step's launches; every step is checked
            launches["flash_whole"] = got["flash_whole"]
        loss = float(aux["loss"])
        check(got == train_launches and math.isfinite(loss),
              f"train step {i}: launches {got}, loss {loss:.5f}, iou {float(aux['iou']):.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = dict(model.named_parameters())
    moved = [n for n, t in watched.items() if not torch.equal(params[n], t)]
    check(len(moved) == len(TRAIN_WATCH), f"train steps moved {moved}")
    ms = sorted(step_ms)
    print(f"train step (ViT-H f32, 11 clicks): median {ms[len(ms) // 2]:.1f} ms, min "
          f"{ms[0]:.1f}, max {ms[-1]:.1f} over {len(ms)} steps (first {step_ms[0]:.1f}); "
          f"peak memory {peak:.2f} GiB  [{card}]")
    print_device_profile("train step", lambda: step(model, *batches[TRAIN_STEPS], gen_train))

    del model, optimizer, step, batches
    torch.cuda.empty_cache()

    # (c) Checkpoint round trip in the JAX trainer's format, from the card and
    # back, on a vit_tiny trained two steps there (the format does not depend
    # on the model's size; a ViT-H checkpoint is what cli.train writes).
    tiny = build_sam.sam_model_registry["vit_tiny"](device="cuda", seed=3)
    tiny_opt = trainer_lib.make_optimizer(tcfg, tiny)
    tiny_step = trainer_lib.make_train_step(tcfg, tiny_opt)
    gen_tiny = torch.Generator(device=dev).manual_seed(7)
    for im, gt in synthetic_samples(2, tiny.config.image_encoder.img_size, 1):
        tiny_step(tiny, torch.from_numpy(im).to(dev),
                  torch.from_numpy(gt[None].astype(np.float32)).to(dev), gen_tiny)
    tiny_opt.zero_grad(set_to_none=True)
    ckpt_dir = pathlib.Path(__file__).resolve().parent / "build" / "chip_ckpt"
    fresh = sam_lib.Sam(tiny.config, device=dev)
    fresh_opt = trainer_lib.make_optimizer(tcfg, fresh)
    try:
        ckpt_lib.save_checkpoint(str(ckpt_dir), tiny, tiny_opt, 2)
        epoch = ckpt_lib.load_checkpoint(str(ckpt_dir), fresh, fresh_opt)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    same = epoch == 2
    for p, q in zip(tiny.parameters(), fresh.parameters()):
        sp, sq = tiny_opt.state[p], fresh_opt.state[q]
        same &= (q.is_cuda and torch.equal(p, q) and torch.equal(sp["exp_avg"], sq["exp_avg"])
                 and torch.equal(sp["exp_avg_sq"], sq["exp_avg_sq"])
                 and float(sp["step"]) == float(sq["step"]) == 2.0)
    check(same, "vit_tiny checkpoint round trip from the card: parameters and AdamW state "
                "bit for bit")
    del tiny, tiny_opt, fresh, fresh_opt
    torch.cuda.empty_cache()

    # --------------------------------------------------------------------- GPTQ
    gptq_solver_phase(dev, card)
    gptq_encoder_phase(dev, card, "vit_h", vit_h, images[0], w4_launches, reset_counts, counts,
                       repo / "build" / "chip_gptq")

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    csrc, jax_ops = "sam_quantization_tpu_torch/csrc/", "sam_quantization_tpu/ops/"
    sources = {"flash_windowed": ("flash_windowed.cu", jax_ops + "flash_attention.py:242"),
               "flash_global": ("flash_global.cu", jax_ops + "flash_attention.py:552"),
               "flash_whole": ("flash_attn.cu", jax_ops + "flash_attention.py:213"),
               "flash_rowblock": ("flash_attn.cu", jax_ops + "flash_attention.py:680"),
               "quant_matmul": ("quant_matmul.cu", jax_ops + "quant_matmul.py:223"),
               "quant_matmul3": ("quant_matmul.cu", jax_ops + "quant_matmul.py:244"),
               "fused_mlp": ("fused_mlp.cu", jax_ops + "fused_mlp.py:28"),
               "quant_matmul_a8_sym": ("quant_matmul_a8.cu", jax_ops + "quant_matmul.py:369"),
               "quant_matmul_a8": ("quant_matmul_a8.cu", jax_ops + "quant_matmul.py:279"),
               "probe_no_softmax": ("probe_packed.cu", "tools/packed_probe.py:71"),
               "probe_dots_floor": ("probe_heads.cu", "tools/packed_probe.py:97"),
               "probe_presplit": ("probe_heads.cu", "tools/packed_probe.py:111"),
               "probe_pair": ("probe_heads.cu", "tools/global_stage_probe.py:183"),
               "probe_pair_bias": ("probe_heads.cu", "tools/global_stage_probe.py:316")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[(name, JSON_DTYPE.get(name, "bfloat16"))]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
