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
   libraries, nor in ``flash_attn``'s but float32 kernels of the body
   below; the float32 bodies, attention (``csrc/flash_f32.cuh`` in
   ``flash_attn``, ``flash_windowed`` and ``flash_global``) and
   packed-weight, FFMA and no tensor-core instruction, with ptxas's spill
   bytes, 0 for each instantiation; the bfloat16 ``fused_mlp``'s hidden
   h read against its plain version's at pack blocks 12 and 80), and the
   W-A8 kernels
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
   ln 2 (the bias times ln 2 as ``attn_mask``) for the softmax probes; then
   the tuned tiles (``ops/autotune.py``, ``csrc/quant_matmul.cu``): every
   candidate tile of ``quant_matmul`` at ViT-H's six linear shapes (W4) and
   of ``quant_matmul3`` at qkv (W3), float32 and bfloat16, held to the
   plain version, bit-equal to the default tile, and timed; and
   ``tune_model_shapes`` into a temporary table (every tile's SASS and
   ptxas spill bytes are read with the other instantiations); then the
   W-A8 kernels' tiles (``csrc/quant_matmul_a8.cu``'s main build at
   ``autotune.TILES_A8``): 0 spill bytes in ptxas's report of each of its 36
   instantiations, and every candidate tile of both kernels at ViT-H's six
   4-bit linear shapes in bfloat16, bit-equal to the plain version and to
   the default tile, timed, the fastest printed;
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
   ``set_image`` is profiled; then one served bfloat16 ``set_image`` and one
   float32 encode under a tuned table naming the non-default tiles (the
   default where float32 has no other), with
   W4's launch counts, each tile launched, the embedding bit-equal to the
   default tiles';
6. W3 encode: the same ViT-H at 3 bits, one float32 and one bfloat16
   encode with their launch counts, held against its dequantized dense
   model, and each again under a tuned table as in step 5;
7. W4A8 main path: the same ViT-H, RTN symmetric 4-bit (group 128) with
   int8 activations on every block linear (``bench.py --a8``'s
   configuration): held against its dequantized dense model (float32 and
   bfloat16), served like the others with exact launch counts, and one
   ``set_image`` profiled with the per-token quantize pass's share, and one
   ``set_image`` under a tuned table naming 256 x 128 and 256 x 64 (JAX's
   bare keys, read by ``pick_blocks_a8``): the exact launches at each tile,
   the embedding bit-equal to the default tile's; then one bfloat16 encode of
   the asymmetric W4A8 model, and one under the same table;
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
13. AMG and the demo server (``automatic_mask_generator.py``,
    ``utils/amg.py``, ``export_js.py``, ``demo_server.py``): the AMG gate,
    ``vit_tiny_synth`` in float32 through the kernels held to the JAX-written
    golden ``tests/data/amg_crossval.json`` in both of its configurations
    (packed path; crop layers and small-region removal); the seeded ViT-H
    (bf16, dense) on a served 1200x1600 image, 32x32 grid, thresholds off
    and at the defaults (28/4 launches, generate time split into
    ``set_image``, device decode + postprocess and host), the general path
    against the packed one, and one crop layer on a 16x16 grid (5 encodes);
    the demo server from a thread (``/set_image``, three ``/click`` equal to
    ``predict``, ``/embedding`` decoded by ``demo/decoder_ref.py``, round-trip
    ms); and ViT-H RTN W4 g128 with W4's launches;
14. ViT-H fine-tuning in float32 (``train/``): a one-click gradient check of
    ``flash_train`` against eager on the same weights and click, then
    training steps with 11 clicks and AdamW (exactly 28 ``flash_whole``
    launches and no other kernel per step, finite losses, parameters that
    move, step times and peak memory, one profiled step), and a checkpoint
    save/load round trip in the JAX trainer's format from the card, bit for
    bit (on a vit_tiny trained two steps there);
15. GPTQ (``quant/gptq.py``, ``quant/sequential.py``, ``cli/quantize.py``):
    the solver on the card against the same solver on the CPU at ViT-H's
    lin2 and qkv widths (W4 g128; share of equal grid values, largest step,
    loss gap); then ``cli.quantize`` GPTQ W4 g128 of the seeded ViT-H on the
    card (2 synthetic 1024 scenes; seconds, the column loop's share, the
    128 losses), its artifact loaded as ``cli.infer --load`` loads it and
    served in float32 and bfloat16 with W4's exact launch counts and held
    against its dequantized dense model, its float32 ``set_image`` timed
    (median of 3 after a warm-up: the evaluation path's encode); the GPTQ
    and RTN encoders' errors on a held-out scene are printed as a reading;
16. FQ-ViT (``quant/fq/``, ``quant/observers.py``, ``cli.quantize --method
    fq``, FQ serving in ``cli.infer``): ``vit_tiny_synth`` calibrated in
    float32 on the card and on the CPU from the same two normalised scenes
    (PTF + LIS, minmax; the share of scales equal and their largest gap,
    PTF factors equal on >= 99.9% of channels), the quant-mode encode card
    vs CPU from one qparams dict within the CPU tests' 1e-2; then
    ``cli.quantize vit_h --method fq`` on 2 synthetic 1024 scenes from a
    seeded ``.pth`` (calibrate seconds, JAX's 357 qparams),
    ``cli.infer --load --benchmark`` of the artifact, and the quant-mode
    encode timed (median and spread), its ``ln_modes`` all ``int``, its
    embedding against the float32 eager encoder of the unquantized weights
    (random weights: a reading) and the peak memory; no kernel is launched
    under the FQ context anywhere;
17. the parallel package (``parallel/``): a ViT-H bf16 encode at B = 4
    against four B = 1 encodes (28/4 flash launches for the batch and for
    each image), and at B = 8 in W4, W4A8 and cached int8 (each mode's
    launches per batch equal to one image's); ``SamServer`` (max_batch 8 and 1, 5 ms wait) fed 16
    requests of 1024 images with 1-3 clicks by 4 client threads, each
    result held against that request run alone, with images/s, latency
    p50 / p95, batches formed and peak memory as readings; then a one-rank
    NCCL world: ``reduce_loss_dict``, ``sp_attention`` at the ViT-H global
    shape against its reference, one ``MultiHostSamServer`` tick against
    ``SamServer``'s batch, the float32 ViT-H under ``tensor_parallel`` at tp
    1 against the eager encoder (no kernel launched; W4: 128
    ``quant_matmul`` and nothing else), and a float32 dp
    train step (2 clicks given) bit for bit against the plain step, each
    step's ms and peak memory printed as readings; where
    the machine has two cards, a two-rank NCCL world (tp 2 encoder, dp 2
    step). The world is destroyed after, and the script says which ran;
18. the FQ-ViT classifiers and the BRS predictors (``models/vit_classifier``,
    ``models/swin_classifier``, ``cli.test_quant``, ``evaluation/lbfgs``,
    ``evaluation/predictors``' BRS, ``cli.evaluate --mode``): DeiT-B and
    Swin-T at full width and depth from seeded weights, batch 8, float32
    logits card vs CPU, FQ calibration over 2 batches on both devices (held
    as step 16 holds SAM's scales), quant-mode logits card vs CPU on the
    CPU's qparams, ``cli.test_quant deit_base`` and ``swin_tiny`` with few
    small batches, no kernel launched; vit_tiny_synth InputBRS and f-BRS card
    vs CPU on the CPU's clicks at opt_steps 2 and at the defaults; ViT-H
    float32 through each BRS predictor (28/4 flash launches a ``set_image``,
    none in ``get_prediction``; ms a click and the loss after each step, no
    step with sufficient decrease raising it); ``cli.evaluate vit_tiny --mode
    InputBRS``. In step 17's one-rank NCCL world it adds the W4A8 ViT-H under
    ``tensor_parallel`` at tp 1 (128 ``quant_matmul_a8_sym``, proj and lin2
    quantizing at the all-reduced token amax) and ``sp_attention``'s
    gradients against the reference's; its two-rank world also holds W4A8 tp 2
    against tp 1 and the two-rank gradients.
19. the export tail (``export.py``, ``export_onnx/``, ``csrc/aoti_runner.cpp``,
    ``cli.export``, ``utils/experiment.Profiler``, ``sam.forward``), on the
    seeded ViT-H: (b) the ONNX decoder at SAM's widths (3 clicks) built from
    the card's model, byte-equal to the one built from a CPU copy of its
    decoder, run by the numpy runtime on a kernel-path ``set_image``
    embedding against ``SamDecoderModule`` on the card (float32, both mask
    gates); (d) ``torch.export`` of the ViT-H decoder and float32 encoder
    (its first 8 blocks), saved, loaded and run against the eager module
    (the .pt2 files in
    ``build/chip_export/``, deleted after), and a W4 and a W4A8 vit_tiny
    encoder exported on the card: their programs hold the kernel ops and
    launch the dequant-matmul kernels 16 times a run, none in the export,
    and the AOTInductor packager refuses them; (e) AOTInductor: a
    cached-int8 vit_tiny encoder (sym W4 g128, static scales from one seeded
    image) compiled for the card and run from Python and by the C++ runner
    (built with ``g++`` against this PyTorch, CUDA libraries linked) against
    its eager encoder (the decoder package is held by the CPU tests); (c)
    the ONNX ViT-B float32 encoder (its first 4 blocks) through the numpy
    runtime against the card's eager encoder, and ViT-H's refused before
    anything is serialized (past protobuf's 2 GiB); (f) ``Profiler(2, 2, 6)`` around 10 bf16
    ``set_image`` calls, whose Chrome trace names 6 x 28/4 flash kernels;
    (a) ``sam.forward`` in bf16 at B = 2 (28/4 launches) against the same
    forward in float32 on the eager path, and against per-image encode +
    decode; (g) ``python -m sam_quantization_tpu_torch.cli.export vit_h
    --format onnx``. Each part's seconds are printed. (e)'s package is
    compiled by a process of its own (``python3 chip_smoke.py
    --aoti-package DIR``), started first, and checked after step 23: the
    compile (142-183 s of host compilers on an NVIDIA H100 80GB HBM3
    machine at 700 W) runs beside steps 19-23.
20. rel-pos resize (``models/image_encoder.get_rel_pos``): a ViT-H global
    attention whose 127-row tables are resized for grids 48 and 32 (shrunk
    to 95 and 63 rows) and 80 and 128 (grown to 159 and 255): the card's
    resized table against the CPU's, and in float32 and bfloat16 the
    kernel JAX's dispatch picks (``flash_rowblock`` at 48 and 80,
    ``flash_global`` at 32 and 128) against its plain version, and the
    module's kernel branch (one launch) against its eager branch.
21. the hoisted-windowed path (``SAMQ_HOIST_PROJ``, ``SAMQ_HOIST_QKV``):
    ViT-H bf16 served dense, W4 and cached int8, each partition-first, then
    with proj hoisted, then with proj and qkv hoisted (the gates set before
    the arm's first call): launches a ``set_image`` (the mode's, in every
    arm), the embedding against partition-first's (rel L2 5e-2, and whether
    bit-equal), and the device ms of the 28 windowed blocks under the
    profiler.
22. the quantization-quality table and its trainer (``tools/quality_table``,
    ``tools/train_synthetic``): the committed ``vit_tiny_synth`` table on
    the card (QUALITY_SCENES held-out scenes), its default rows on the eager
    branch, then the three kernel-path rows merged in on the kernel branch:
    both runs exit 0 with ``ci_ok`` (each kernel row inside its base row's
    CI95), every encode's launches exact; ``train_synthetic --resume`` for
    20 steps on a copy of it (finite losses, 4 ``flash_whole`` launches a
    step), its ``latest`` read back by the table within a tolerance set from
    CPU runs; and the same table at ViT-H widths on a seeded checkpoint
    written by the port (fp32 eager: no launch; RTN W4 and bf16 on the
    kernel branch: 64 ``quant_matmul``, 32 ``fused_mlp`` and 28/4 flash, and
    28/4 flash, an encode).
23. the stage-anatomy probes and the FQ override search (``tools/timing.
    timed_carry``, ``tools/block_anatomy``, ``attn_stage_probe``,
    ``mlp_serving_probe``, ``rel_probe``, ``fq_tune``): ``block_anatomy
    --model vit_h --int4 --a8`` and the other three probes at ViT-H widths,
    each stage STAGE_ITERS applications captured in one CUDA graph and
    replayed beside the same loop launched eagerly: every time finite and
    above zero, the replayed carry bit-equal to the eager loop's, the
    launches counted over the capture exactly STAGE_ITERS applications'
    (BLOCK_STAGE_LAUNCHES, ATTN_CASE_LAUNCHES) and none over the replays;
    ``fq_tune --configs base diag8`` on ``vit_tiny_synth`` at 4 scenes on
    the CPU and on the card given the CPU's qparams (rows within 1e-3
    mIoU, NoC and worst-8 lists equal), and free running on the card
    (rows within 1e-2; the points where its calibration differs from the
    CPU's printed).

Each step prints its seconds (``step N ...: s``), and a line after step 23
all of them. The line before the last is a JSON object with one entry per kernel build
(its ``dtype``; the packed-weight kernels in float32 and bfloat16, and the
tuned tiles of ``quant_matmul``, ``quant_matmul3``, ``quant_matmul_a8_sym``
and ``quant_matmul_a8`` other than the default, named by their tile); the
last
line is ``{"ok": true, "device": {...}}``. It exits non-zero, without that
line, when there is no CUDA device, when the package is missing, or when any
check fails.
"""

from __future__ import annotations

import argparse
import atexit
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
import threading
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
# AMG: the golden's tolerances are the CPU tests' (tests/test_torch_amg.py
# AMG_TOL): a logit within rounding of the threshold may flip a pixel, and a
# flip moves a small mask's stability by 1/lo. The packed path's stability is
# an int32-count float32 quotient, the general path's float64 (JAX's own
# test holds the two to 1e-6).
AMG_TOL = {"pixels": 1e-3, "bbox": 1.0, "iou": 1e-4, "stability": 1e-3, "area": 0}
AMG_PACKED_STAB_TOL = 1e-6
AMG_OFF = {"pred_iou_thresh": -1e9, "stability_score_thresh": 0.0}  # every mask kept
AMG_SIDE, AMG_BATCH, AMG_CROP_SIDE = 32, 64, 16
# FQ-ViT: activation ranges card vs CPU differ by float32 sum order (the CPU
# tests read 4e-7 port vs JAX), so a scale may move by an ulp or so and a PTF
# factor flip where two candidates tie. The quant-mode encode is held as the
# CPU tests hold port vs JAX (tests/test_torch_fq_encoder.py): fed the CPU's
# input at each observation point, the card's point outputs bit-equal and
# its inputs between points within FQ_GAP_TOL; free running within
# FQ_ENCODE_TOL, or, past it, a cascade that starts at a point whose input
# is within float32 rounding and whose outputs are one grid step apart
# (bounded by FQ_CASCADE_TOL). JAX's count of ViT-H points under FQConfig()
# (PTF + LIS): jax.eval_shape of image_encoder.apply(VIT_H) under
# FQCtx("last_calib") holds 357 new qparams, 67 of them channel-wise.
FQ_SCALE_RTOL = 1e-5
FQ_PTF_SHARE = 0.999
FQ_GAP_TOL = 1e-5
FQ_ENCODE_TOL = 1e-2
FQ_CASCADE_TOL = 0.1
FQ_QPARAMS_VIT_H = 357
FQ_ITERS = 3
SERVER_CLICKS = ((800.0, 600.0, 1), (300.0, 900.0, 0), (1200.0, 200.0, 1))
DECODER_REF_TOL = 1e-3  # tests/test_demo_server.py's IoU tolerance
# Parallel phase (step 17). A batch of 4 through the kernels against four
# encodes of one: the kernels compute each image's rows alike, and cuBLAS may
# tile a GEMM of 4x the rows otherwise, so the bound is the bf16 kernel
# path's own (rel. L2 5e-2, as against float32 eager in step 4); the server's
# results against each request run alone take the same bound on the low-res
# logits and on |IoU|.
BATCH_TOL = 5e-2
SERVER_REQUESTS, SERVER_CLIENTS, SERVER_BATCH, SERVER_WAIT_MS = 16, 4, 8, 5.0
# The ViT-H float32 encoder's tensor-parallel branch at tp 1 against the
# eager branch: the same products, the rel bias added to the logits as one
# sum (rel_h + rel_w) rather than in two steps, and a one-rank all-reduce.
TP1_TOL = 1e-4
# Two-rank NCCL worlds (only where the machine has two cards): tp 2 against
# the unsharded encoder, float32, rel. L2; the dp 2 step against the
# one-process step on the full batch, parameters rel. L2 over the model
# (the CPU tests read 1.4e-7 to 1.7e-7 at vit_tiny).
TP2_TOL, DP2_TOL = 1e-4, 1e-6
# Step 18. DeiT-B and Swin-T, card vs CPU, float32 (TF32 off), batch 8:
# the logits differ by float32 sum order only (first H100 run: 1.44e-6 and
# 3.82e-7, limit 1e-4). The quant mode is held as step 16 holds SAM's
# encoder: every point's output bit-equal when fed the CPU's input, the
# inputs between points within FQ_GAP_TOL; free running, an activation
# within rounding of a grid point on one device flips by a step and the
# flips cascade through the blocks onto random-weight logits, which are
# small and near-uniform: the first run read 9.57e-2 (DeiT-B, 12 blocks)
# and 1.80e-2 (Swin-T), past the CPU tests' QUANT_TOL, so past it the run
# must be such a traced cascade within CLF_CASCADE_TOL. BRS maps of
# vit_tiny_synth card vs CPU (max |d prob|): at opt_steps 2 the decoders'
# rounding through two line searches (first run 1.6e-6); at the defaults
# (10 and 15 steps) L-BFGS may part further (5.6e-6 and 4.5e-5). The W4A8
# ViT-H under tensor_parallel at tp 1 against its eager path: the TP
# attention sums the rel bias in another order (dense: 1.7e-6), which moves
# int8 roundings at proj's input, and the steps cascade over 32 blocks
# (first run 2.02e-2, inside the W4A8 f32 embedding bound A8_F32_TOL); each
# row shard against its layer on one input is bit-equal. sp_attention's
# one-rank gradients against the reference's (SP_GRAD_TOL, max |d|; first
# run 0).
CLF_BATCH = 8
CLF_FLOAT_TOL = 1e-4
CLF_QUANT_TOL = 1e-2
CLF_CASCADE_TOL = 0.25
# Fed the CPU's input, a point's output on the card may still differ where
# LIS takes log2 of a probability within an ulp of a rounding boundary
# (CUDA's logf against the CPU's); first run, before each stretch was held
# alone: 4 values (DeiT-B) and 33 (Swin-T), of about 4.5e7 and 1.9e7.
CLF_LIS_FLIP_SHARE = 1e-5
BRS_CARD_TOL = 1e-3
BRS_CARD_DEFAULT_TOL = 5e-2
SP_GRAD_TOL = 1e-5
# W4A8 tp 2 against tp 1 (two cards only): the partial sums of proj and lin2
# change the residual stream's float order, and a value within rounding of
# an int8 rounding point moves its product by one activation step (the CPU
# tests read 3e-7 at vit_tiny; over 32 blocks the steps cascade, as at tp
# 1 against the eager path), so the W4A8 f32 embedding bound.
A8_TP2_TOL = A8_F32_TOL
# Step 19 (export). sam.forward in bf16 through the kernels at B = 2
# against the same forward in float32 on the eager path: BATCH_TOL, the bf16
# kernel path's bound against float32 eager (step 4). Against per-image
# encode + decode through the same kernels: FORWARD_SPLIT_TOL, set from the
# first H100 run (5.846e-5): cuBLAS may tile a GEMM of 2x the rows
# otherwise, which moves a few bf16 roundings, well below one bf16 step
# (2**-8) of rel. L2. The ONNX decoder's numpy runtime against
# SamDecoderModule on the card (float32, TF32 off), max |d|: masks and
# low-res logits ONNX_MASK_TOL, IoU ONNX_IOU_TOL; the ViT-B ONNX encoder's
# numpy runtime against the card's eager encoder, rel. L2 ONNX_ENC_TOL:
# float32 sums in another order on each side. torch.export programs against
# their eager module (the same aten ops and, for packed layers, the same
# kernels): EXPORT_TOL. The cached-int8 AOTInductor package (fused Triton
# pointwise code) against its eager encoder: INT8_F32_TOL (an activation
# within rounding of an int8 point may flip, and flips cascade over the
# blocks, as between step 10's two paths).
ONNX_MASK_TOL, ONNX_IOU_TOL, ONNX_ENC_TOL = 1e-3, 1e-4, 1e-4
EXPORT_TOL, FORWARD_SPLIT_TOL = 1e-5, 5e-3
# The cached-int8 AOTInductor encoder is vit_tiny: ViT-B's compile for the
# card took 202.5 s on an H100, past the step's budget for it (about 180 s).
ONNX_ENCODER, AOTI_ENCODER = "vit_b", "vit_tiny"
# Depths of step 19's encoders that are exported whole: the ONNX ViT-B
# encoder run by the numpy runtime (on the host: 40 s at ViT-B's 12 blocks)
# and the float32 ViT-H encoder's .pt2 (written, read back and run: 34 s at
# 32 blocks; both on the host of an NVIDIA H100 80GB HBM3, 700 W). Each keeps a global block (ViT-B's 2, ViT-H's 7) among
# windowed ones; the ViT-H decoder and ViT-H's 2 GiB refusal are whole.
ONNX_ENCODER_DEPTH, EXPORT_ENCODER_DEPTH = 4, 8
AOTI_WAIT_S = 600  # most seconds step 19 (e)'s finish waits for its compile
PROFILE_WINDOW = (2, 2, 6)  # Profiler wait, warmup, active around 10 set_image calls
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


def ptxas_usage(log: str, pattern: str) -> dict:
    """{key: (spill store bytes, spill load bytes, registers)} of each kernel
    whose mangled name matches ``pattern`` in ``nvcc -Xptxas -v`` output (the
    key is the pattern's groups, as in :func:`tensor_core_counts`)."""
    import re

    usage, key = {}, None
    for line in log.splitlines():
        m = re.search(pattern, line)
        if m and ("Function properties for" in line or "Compiling entry function" in line):
            key = m.groups()
            usage.setdefault(key, [None, None, None])
        elif key and (sp := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            usage[key][0], usage[key][1] = int(sp.group(1)), int(sp.group(2))
        elif key and (used := re.search(r"Used (\d+) registers", line)):
            usage[key][2] = int(used.group(1))
            key = None
    return {k: tuple(v) for k, v in usage.items()}


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
            if dtype == torch.float32:  # the evaluation path's encode (click_eval)
                ms = []
                for _ in range(3):  # after the warm-up set_image above
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    predictor.set_image(image)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
                ms.sort()
                print(f"GPTQ W4 {name} float32 set_image ({h}x{w}): median {ms[1]:.2f} ms, "
                      f"min {ms[0]:.2f}, max {ms[2]:.2f} over 3  [{card}]")
    gptq_err = float((gptq_out - fp_out).norm() / fp_out.norm())
    print(f"GPTQ W4 g128 {name}, held-out scene, encoder rel. L2 vs float32 (random weights, "
          f"a reading): GPTQ {gptq_err:.4e}, RTN {rtn_err:.4e}")
    del qmodel, ref, fp_out, gptq_out
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"GPTQ phase ({name}): {time.perf_counter() - phase_t:.1f} s  [{card}]")


def _points_ctx():
    """The FQ quant-mode context class that keeps each observation point's
    input and output on the CPU (step 16's and step 18's point-by-point
    checks)."""
    from sam_quantization_tpu_torch.quant.fq import pipeline as fq

    class Points(fq.FQCtx):
        """Quant mode keeping each point's input and output on the CPU; given
        another run's record, each point runs on that run's input instead of
        its own (the gap between the two is kept) and passes that run's
        output on, so each stretch between two points is held alone."""

        def __init__(self, rec, *a, **k):
            super().__init__(*a, **k)
            self.rec, self.inputs, self.outputs, self.gaps = rec, {}, {}, {}

        def _take(self, path, x):
            self.inputs[path] = x.cpu()
            if self.rec is None:
                return x
            want = self.rec[path][0]
            self.gaps[path] = float((x.cpu() - want).norm() / want.norm().clamp(min=1e-30))
            return want.to(x.device)

        def _give(self, path, y):
            self.outputs[path] = y.cpu()
            return y if self.rec is None else self.rec[path][1].to(y.device)

        def act(self, path, x, ln_input=False):
            return self._give(path, super().act(path, self._take(path, x), ln_input=ln_input))

        def softmax(self, path, attn, scale_path=None, dim=-1):
            return self._give(path, super().softmax(path, self._take(path, attn),
                                                    scale_path=scale_path, dim=dim))

    return Points


def _held_points(cpu, free, forced, qparams, out_card, out_cpu, tol: float,
                 cascade_tol: float):
    """Step 16's reading of a quant-mode forward run three ways (``cpu``,
    ``free`` on the card, ``forced``: the card fed the CPU's input at each
    point): ({point: values differing in its forced output} for the points
    that differ, the largest input gap between points, free-running rel. L2,
    a text, whether the free run passes: within ``tol``, or a cascade from a
    point whose input is within float32 rounding and whose outputs are one
    grid step apart, within ``cascade_tol``)."""
    import torch

    flips = {p: int((forced.outputs[p] != cpu.outputs[p]).sum()) for p in cpu.outputs}
    flips = {p: n for p, n in flips.items() if n}
    gap = max(forced.gaps.values())
    rel = float((out_card.cpu() - out_cpu).norm() / out_cpu.norm())
    first = next((p for p in cpu.outputs if not torch.equal(free.outputs[p], cpu.outputs[p])),
                 None)
    cascade, ok = "none", rel <= tol
    if first is not None:
        in_gap = float((free.inputs[first] - cpu.inputs[first]).norm()
                       / cpu.inputs[first].norm())
        d = (free.outputs[first] - cpu.outputs[first]).abs()
        steps = (d / qparams[first][0].cpu())[d > 0]  # in grid steps (per channel under PTF)
        one_step = bool(torch.allclose(steps, torch.ones_like(steps), rtol=1e-5))
        cascade = (f"first differing point {first}: input rel gap {in_gap:.2e}, {steps.numel()} "
                   f"values one grid step apart {one_step}")
        ok = ok or (in_gap <= 1e-6 and one_step and rel <= cascade_tol)
    return flips, gap, rel, cascade, ok


def fq_phase(dev, card: str, name: str, build, n_qparams: int, reset_counts, counts, zero: dict,
             workdir: pathlib.Path) -> None:
    """FQ-ViT (module docstring, step 16): (a) vit_tiny_synth card vs CPU;
    (b) the seeded model ``build()`` returns (``name``) through the CLIs,
    with JAX's ``n_qparams`` points."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.cli import build_model
    from sam_quantization_tpu_torch.cli import infer as infer_cli
    from sam_quantization_tpu_torch.cli import quantize as quantize_cli
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.quant import artifacts
    from sam_quantization_tpu_torch.quant.fq import pipeline as fq
    from sam_quantization_tpu_torch.quant.sequential import full_float32
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib

    phase_t = time.perf_counter()
    cfg = fq.FQConfig()

    # (a) vit_tiny_synth, float32: the same calibration on both devices.
    repo = pathlib.Path(__file__).resolve().parent
    tiny = build_sam.sam_model_registry["vit_tiny"](device="cpu")
    ckpt_lib.load_weights(str(repo / "checkpoints" / "vit_tiny_synth"), tiny, "best")
    scenes = [sam_lib.preprocess(tiny, torch.from_numpy(img))
              for img, _ in synthetic_samples(2, tiny.config.image_encoder.img_size, 0)]
    enc_cpu, enc_card = tiny.image_encoder, copy.deepcopy(tiny.image_encoder).to(dev)
    reset_counts()
    q_card = fq.calibrate_encoder(enc_card, cfg, [x.to(dev) for x in scenes])
    torch.cuda.synchronize()
    calib_counts = counts()
    q_cpu = fq.calibrate_encoder(enc_cpu, cfg, scenes)
    layer = [k for k, (sc, _) in q_cpu.items() if sc.ndim == 0]
    ptf = [k for k in q_cpu if k not in layer]
    equal = sum(bool(torch.equal(q_card[k][0].cpu(), q_cpu[k][0])) for k in layer)
    gap = max(float(((q_card[k][0].cpu() - q_cpu[k][0]).abs() / q_cpu[k][0]).max()) for k in q_cpu)
    zeros_equal = all(torch.equal(q_card[k][1].cpu(), q_cpu[k][1]) for k in q_cpu)
    factors = [tuple(torch.round(sc / sc.min()) for sc in (q_card[k][0].cpu(), q_cpu[k][0]))
               for k in ptf]
    same = sum(int((a == b).sum()) for a, b in factors)
    total = sum(a.numel() for a, _ in factors)
    check(sorted(q_card) == sorted(q_cpu) and calib_counts == zero and gap <= FQ_SCALE_RTOL
          and zeros_equal and same >= FQ_PTF_SHARE * total,
          f"FQ vit_tiny_synth calibration, card vs CPU (f32, 2 scenes, PTF+LIS minmax): "
          f"{len(q_card)} points; layer-wise scales bit-equal {equal}/{len(layer)}, largest "
          f"rel gap {gap:.2e} (<= {FQ_SCALE_RTOL}); zeros equal {zeros_equal}; PTF factors "
          f"equal on {same}/{total} channels ({same / total:.4%} >= {FQ_PTF_SHARE:.1%}); "
          f"launches on the card {'none' if calib_counts == zero else calib_counts}  [{card}]")
    qenc_card, qenc_cpu = fq.fq_quantize_weights(enc_card, cfg), fq.fq_quantize_weights(enc_cpu, cfg)
    weights_equal = all(torch.equal(a.cpu(), b) for a, b in
                        zip(qenc_card.state_dict().values(), qenc_cpu.state_dict().values()))

    Points = _points_ctx()

    x0 = scenes[0]
    with torch.no_grad(), full_float32():
        cpu = Points(None, "quant", cfg, qparams={k: (s.cpu(), z.cpu()) for k, (s, z) in q_card.items()})
        e_cpu = qenc_cpu(x0, "eager", cpu)
        reset_counts()
        free = Points(None, "quant", cfg, qparams=q_card)
        e_card = qenc_card(x0.to(dev), "kernel", free).cpu()
        forced = Points({p: (cpu.inputs[p], cpu.outputs[p]) for p in cpu.outputs}, "quant", cfg,
                        qparams=q_card)
        qenc_card(x0.to(dev), "kernel", forced)
        torch.cuda.synchronize()
        got = counts()
    flips, gap, rel, cascade, cascade_ok = _held_points(cpu, free, forced, q_card, e_card, e_cpu,
                                                        FQ_ENCODE_TOL, FQ_CASCADE_TOL)
    check(weights_equal and got == zero and not flips and gap <= FQ_GAP_TOL and cascade_ok
          and set(free.ln_modes.values()) == {"int"} and free.ln_modes == cpu.ln_modes,
          f"FQ vit_tiny_synth quant-mode encode (card qparams), card vs CPU: weights bit-equal "
          f"{weights_equal}; fed the CPU's inputs, {len(cpu.outputs)} points' outputs differ in "
          f"{sum(flips.values())} values (0), inputs between points rel gap <= {gap:.2e} (<= {FQ_GAP_TOL}); free "
          f"running rel L2 {rel:.3e} (<= {FQ_ENCODE_TOL}, or a traced cascade <= "
          f"{FQ_CASCADE_TOL}: {cascade}); {len(free.ln_modes)} LNs int; launches "
          f"{'none' if got == zero else got}  [{card}]")
    del tiny, enc_card, qenc_card, qenc_cpu, q_card, q_cpu

    # (b) The full model through the CLIs, from a seeded .pth.
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    model = build()
    pth = workdir / f"{name}_seeded.pth"
    torch.save(model.state_dict(), pth)
    size = model.config.image_encoder.img_size
    scene = next(synthetic_samples(1, size, seed=7))[0]
    held_out = sam_lib.preprocess(model, torch.from_numpy(scene).to(dev))  # calibration: seed 0
    with torch.no_grad(), full_float32():
        fp_out = model.image_encoder(held_out, "eager").float()
    del model
    torch.cuda.empty_cache()

    spent = {"calibrate": 0.0}
    calibrate = fq.calibrate_encoder

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = calibrate(*a, **k)
        torch.cuda.synchronize()
        spent["calibrate"] += time.perf_counter() - t
        return out

    art = workdir / "fq"
    fq.calibrate_encoder = timed
    out = io.StringIO()
    reset_counts()
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = quantize_cli.main([name, "--checkpoint", str(pth), "--method", "fq",
                                    "--nsamples", "2", "--save", str(art)])
        quant_s = time.perf_counter() - t
    finally:
        fq.calibrate_encoder = calibrate
    got = counts()
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    n_qp = len(artifacts.load_fq_qparams(str(art)))
    check(rc == 0 and last["status"] == "ok" and last["method"] == "fq" and got == zero
          and n_qp == n_qparams,
          f"cli.quantize {name} --method fq (PTF+LIS minmax, 2 synthetic {size} scenes) on the card: "
          f"calibrate {spent['calibrate']:.2f} s, cli {last['elapsed_s']} s (with the weights' "
          f"fake-quant), {quant_s:.1f} s with the model's load and the artifact's save; "
          f"{n_qp} qparams (JAX: {n_qparams}); launches {'none' if got == zero else got}"
          f"  [{card}]")

    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = infer_cli.main([name, "--checkpoint", str(pth), "--load", str(art), "--benchmark",
                             "--bench-iters", "2", "--bench-warmup", "1"])
    got = counts()
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0 and got == zero and "loaded FQ activation qparams" in err.getvalue()
          and last["encoder_s_per_image"] > 0,
          f"cli.infer {name} --load (FQ) --benchmark: {last['encoder_s_per_image'] * 1e3:.1f} ms "
          f"an image (mean of 2, float32, eager), launches {'none' if got == zero else got}"
          f"  [{card}]")

    qmodel, qcfg = build_model(argparse.Namespace(model=name, checkpoint=str(pth),
                                                  ckpt_name="best", load=str(art)), dev)
    fqcfg = fq.FQConfig(int_softmax=qcfg["lis"], int_norm=qcfg["ptf"],
                        observer_a=qcfg["quant_method"])
    qparams = fq.qparams_to(artifacts.load_fq_qparams(str(art)), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    with torch.no_grad(), full_float32():
        for _ in range(FQ_ITERS):
            ctx = fq.FQCtx("quant", fqcfg, qparams=qparams)
            torch.cuda.synchronize()
            t = time.perf_counter()
            e = sam_lib.encode_image(qmodel, held_out, "kernel", ctx).float()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        got = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print_device_profile(f"FQ encode {name}", lambda: sam_lib.encode_image(
            qmodel, held_out, "kernel", fq.FQCtx("quant", fqcfg, qparams=qparams)), ranges=(
            (fq.int_ops, "log_int_softmax", "log-int softmax"),
            (fq.int_ops, "int_layer_norm", "integer LN"),
            (fq.quantizers, "uniform_fake_quant", "fake-quant")))
    rel = float((e - fp_out).norm() / fp_out.norm())
    ms = sorted(times)
    depth = qmodel.config.image_encoder.depth
    check(got == zero and len(ctx.ln_modes) == 2 * depth + 2
          and set(ctx.ln_modes.values()) == {"int"} and bool(torch.isfinite(e).all()) and rel < 1.0,
          f"FQ encode {name} f32 (FQCtx quant, attn_impl=kernel: the eager branch): median "
          f"{ms[len(ms) // 2]:.1f} ms, min {ms[0]:.1f}, max {ms[-1]:.1f} over {len(ms)} (first "
          f"{times[0]:.1f}); launches {'none' if got == zero else got}; {len(ctx.ln_modes)} LNs "
          f"all int; embedding vs float32 eager of the unquantized weights rel L2 {rel:.4e} "
          f"(random weights, a reading; < 1); peak memory {peak:.2f} GiB  [{card}]")
    del qmodel, qparams, e, fp_out
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"FQ phase: {time.perf_counter() - phase_t:.1f} s  [{card}]")


def amg_server_phase(dev, card: str, vit_h, images, flash_launches: dict, w4_launches: dict,
                     reset_counts, counts, zero: dict, repo: pathlib.Path) -> None:
    """AMG and the demo server (``automatic_mask_generator.py``,
    ``utils/amg.py``, ``export_js.py``, ``demo_server.py``):

    (a) the AMG gate: ``vit_tiny_synth`` (best) in float32 through the
        kernels on the golden's image, in both of its configurations, held
        to ``tests/data/amg_crossval.json`` (written by the JAX package)
        within the CPU tests' ``AMG_TOL``, with exactly the vit_tiny launches
        of one encode per crop;
    (b) the seeded ViT-H, bf16 encoder, dense, on ``images[0]`` (1200x1600),
        32x32 grid, 64 prompts a batch: thresholds off (all 3,072 masks reach
        the RLE and the NMS) and at the defaults, each with exactly 28/4
        flash launches and no other kernel, every kept RLE's area equal to
        its decoded mask's sum, and the time split into ``set_image``, the
        device decode + postprocess (CUDA events over the batches) and the
        host; then the general path (``packed_fast_path = False``) against
        the packed one on an 8x8 grid, thresholds and NMS off: the same RLE,
        bbox and area, stability within AMG_PACKED_STAB_TOL;
    (c) crop layers (``crop_n_layers=1``, 16x16 grid, thresholds off): five
        encodes' launches, the full crop's 768 masks into its NMS, the four
        crops' general path;
    (d) the demo server from a thread on 127.0.0.1, ViT-H bf16:
        ``/set_image`` (28/4 launches), three ``/click`` (masks byte-equal
        to ``predict`` on the same predictor and clicks), ``/embedding`` and
        the decoder blob, which ``demo/decoder_ref.py`` decodes to the
        server's IoU within DECODER_REF_TOL;
    (e) ViT-H RTN W4 g128 (bf16), thresholds off: W4's launches (64 / 32 /
        28 / 4).
    """
    import base64
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sam_quantization_tpu_torch import automatic_mask_generator as amg_mod
    from sam_quantization_tpu_torch import demo_server, export_js, native
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.predictor import SamPredictor
    from sam_quantization_tpu_torch.quant import sequential as seq
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib
    from sam_quantization_tpu_torch.utils import amg as amg_utils

    phase_t = time.perf_counter()
    Generator = amg_mod.SamAutomaticMaskGenerator
    check(native.get_lib() is not None, f"AMG: host runtime loaded ({native.library_path().name})")

    def generate(gen, image):
        """``gen.generate(image)`` with its wall time split: set_image (host
        clock, synchronised), the device decode + postprocess of every batch
        (CUDA events around each), and the rest, the host's, of which the
        RLE encodes and the NMS calls (host clock); plus the box count of
        each ``native.box_nms`` call."""
        spans, set_s, nms_in, depth = [], [], [], [0]
        host = {"rle": 0.0, "nms": 0.0}
        real = {name: getattr(amg_mod, name) for name in ("_batched_decode",
                                                          "_batched_decode_packed")}
        real_set = gen.predictor.set_image
        real_native = {name: getattr(native, name) for name in (
            "box_nms", "rle_encode_batch", "rle_encode_batch_packed")}

        def on_host(fn, key):
            def run(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    host[key] += time.perf_counter() - t
            return run

        def on_device(fn):
            def run(*a, **k):
                depth[0] += 1
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    return fn(*a, **k)
                finally:
                    end.record()
                    depth[0] -= 1
                    if depth[0] == 0:
                        spans.append((start, end))
            return run

        def set_image(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_set(*a, **k)
            torch.cuda.synchronize()
            set_s.append(time.perf_counter() - t)
            return out

        def box_nms(boxes, scores, thr):
            nms_in.append(len(boxes))
            return real_native["box_nms"](boxes, scores, thr)

        for name, fn in real.items():
            setattr(amg_mod, name, on_device(fn))
        gen.predictor.set_image = set_image
        native.box_nms = on_host(box_nms, "nms")
        for name in ("rle_encode_batch", "rle_encode_batch_packed"):
            setattr(native, name, on_host(real_native[name], "rle"))
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            anns = gen.generate(image)
            torch.cuda.synchronize()
            total = time.perf_counter() - t
        finally:
            for name, fn in real.items():
                setattr(amg_mod, name, fn)
            del gen.predictor.set_image
            for name, fn in real_native.items():
                setattr(native, name, fn)
        decode = sum(s.elapsed_time(e) for s, e in spans) / 1e3
        return anns, {"total": total, "set_image": sum(set_s), "decode": decode,
                      "host": total - sum(set_s) - decode, **host, "batches": len(spans),
                      "nms_in": nms_in}

    def report(what, anns, split):
        print(f"AMG {what}: {len(anns)} annotations, generate {split['total']:.3f} s = "
              f"set_image {split['set_image']:.3f} + device decode/postprocess "
              f"{split['decode']:.3f} ({split['batches']} batches) + host {split['host']:.3f} "
              f"(RLE {split['rle']:.3f}, NMS {split['nms']:.3f}); "
              f"boxes into each NMS {split['nms_in']}  [{card}]")

    def areas_ok(anns):
        return all(int(amg_utils.annotation_mask(a).sum()) == a["area"] for a in anns)

    # (a) The gate against the JAX golden, float32 kernels.
    golden = json.loads((repo / "tests" / "data" / "amg_crossval.json").read_text())
    shape = golden["image"]["shape"]
    image = np.frombuffer(base64.b64decode(golden["image"]["uint8_base64"]),
                          np.uint8).reshape(shape).copy()
    scene = next(synthetic_samples(1, 128, seed=5))[0][0, : shape[0], : shape[1]]
    check(np.array_equal(image, scene.astype(np.uint8)),
          "AMG gate: the golden's image regenerated bit for bit by data/synthetic.py")
    tiny = build_sam.sam_model_registry["vit_tiny"](device="cuda")
    ckpt_lib.load_weights(str(repo / "checkpoints" / "vit_tiny_synth"), tiny, "best")
    for name, cfg in golden["configs"].items():
        gen = Generator(tiny, output_mode="uncompressed_rle", **cfg)
        n_crops = len(amg_utils.generate_crop_boxes(image.shape[:2], gen.crop_n_layers,
                                                    gen.crop_overlap_ratio)[0])
        reset_counts()
        anns, split = generate(gen, image)
        got = counts()
        want = {**zero, **{k: n * n_crops for k, n in TINY_LAUNCHES.items()}}
        gaps = amg_utils.annotation_gaps(golden["annotations"][name], anns)
        print(f"AMG gate {name}: {gaps}, {split['total']:.3f} s  [{card}]")
        check(gaps["ref"] == gaps["got"] == gaps["matched"] > 0
              and all(gaps[k] <= tol for k, tol in AMG_TOL.items()),
              f"AMG gate {name} vs the JAX golden: {gaps['got']}/{gaps['ref']} annotations, "
              f"matched {gaps['matched']}; pixels {gaps['pixels']:.2e}, bbox {gaps['bbox']}, "
              f"iou {gaps['iou']:.2e}, stability {gaps['stability']:.2e}, area {gaps['area']} "
              f"(<= {AMG_TOL})")
        check(got == want, f"AMG gate {name}: {n_crops} encodes, launches "
                           f"{ {k: n for k, n in got.items() if n} }")
    del tiny

    # (b) ViT-H bf16 dense on the served 1200x1600 image.
    model = vit_h()
    model.image_encoder.to(torch.bfloat16)
    image = images[0]
    n_masks = AMG_SIDE * AMG_SIDE * 3
    for what, kw, mode in (("thresholds off", AMG_OFF, "uncompressed_rle"),
                           ("defaults", {}, "binary_mask")):
        gen = Generator(model, points_per_side=AMG_SIDE, points_per_batch=AMG_BATCH,
                        output_mode=mode, **kw)
        reset_counts()
        anns, split = generate(gen, image)
        got = counts()
        report(f"ViT-H bf16 {AMG_SIDE}x{AMG_SIDE} {what}", anns, split)
        check(got == flash_launches and areas_ok(anns)
              and (kw != AMG_OFF or split["nms_in"] == [n_masks]),
              f"AMG ViT-H bf16 {what}: launches { {k: n for k, n in got.items() if n} }, "
              f"{len(anns)} kept, each RLE's area its mask's sum, boxes into NMS "
              f"{split['nms_in']}")
        del anns
    # One batch's device work by kernel: decode, upsample, stability, pack.
    gen.predictor.set_image(image)
    grid = gen.point_grids[0][:AMG_BATCH] * np.array(image.shape[:2])[None, ::-1]
    coords, labels = gen._prompts(grid, image.shape[:2])
    print_device_profile("AMG one packed batch (64 prompts, 192 masks)", lambda: (
        amg_mod._batched_decode_packed(model, gen.predictor.features, coords, labels, len(grid),
                                       gen.predictor.input_size, image.shape[:2], 0.0, 1.0)))
    gen.predictor.reset_image()
    small = {**AMG_OFF, "box_nms_thresh": 1.0, "points_per_side": 8,
             "points_per_batch": AMG_BATCH, "output_mode": "uncompressed_rle"}
    paths = {}
    for packed in (True, False):
        gen = Generator(model, **small)
        gen.packed_fast_path = packed
        paths[packed], split = generate(gen, image)
        report(f"ViT-H bf16 8x8 {'packed' if packed else 'general'} path", paths[packed], split)
    fast, general = paths[True], paths[False]
    stab = max((abs(f["stability_score"] - g["stability_score"])
                for f, g in zip(fast, general)), default=0.0)
    check(len(fast) == len(general) == 192
          and all(f["segmentation"]["counts"] == g["segmentation"]["counts"]
                  and f["bbox"] == g["bbox"] and f["area"] == g["area"]
                  for f, g in zip(fast, general)) and stab <= AMG_PACKED_STAB_TOL,
          f"AMG ViT-H packed vs general path, 8x8: {len(fast)} / {len(general)} annotations, "
          f"same RLE, bbox and area; stability max |d| {stab:.2e} (<= {AMG_PACKED_STAB_TOL})")
    del paths, fast, general

    # (c) Crop layers: the full image (packed), then four crops (general).
    gen = Generator(model, points_per_side=AMG_CROP_SIDE, points_per_batch=AMG_BATCH,
                    crop_n_layers=1, output_mode="uncompressed_rle", **AMG_OFF)
    reset_counts()
    anns, split = generate(gen, image)
    got = counts()
    report(f"ViT-H bf16 crop layer 1, {AMG_CROP_SIDE}x{AMG_CROP_SIDE}", anns, split)
    per_crop = AMG_CROP_SIDE * AMG_CROP_SIDE * 3
    nms_in = split["nms_in"]
    check(got == {k: 5 * n for k, n in flash_launches.items()} and len(nms_in) == 6
          and nms_in[0] == per_crop and all(n <= per_crop for n in nms_in[1:5])
          and 0 < len(anns) <= nms_in[5] <= sum(nms_in[:5]) and areas_ok(anns),
          f"AMG ViT-H crop layer 1: launches { {k: n for k, n in got.items() if n} } (5 "
          f"encodes), boxes into the crops' NMS {nms_in[:5]} and the crop NMS {nms_in[5:]}, "
          f"{len(anns)} annotations, areas their masks' sums")
    del anns, gen

    # (d) The demo server, ViT-H bf16, from a thread.
    predictor = SamPredictor(model)
    manifest, blob = export_js.flatten_decoder(model)
    server = demo_server.make_server(predictor, manifest, blob, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(path, body=None):
        req = urllib.request.Request(url + path, None if body is None else
                                     json.dumps(body).encode())
        t = time.perf_counter()
        out = urllib.request.urlopen(req, timeout=300).read()
        return out, (time.perf_counter() - t) * 1e3

    try:
        sys.path.insert(0, str(repo / "demo"))
        from decoder_ref import DecoderRef

        image = images[1]
        h, w = image.shape[:2]
        rgba = np.concatenate([image, np.full((h, w, 1), 255, np.uint8)], -1)
        call("/set_image", {"rgba": base64.b64encode(rgba.tobytes()).decode(),
                            "height": h, "width": w})  # warm-up
        reset_counts()
        out, set_ms = call("/set_image", {"rgba": base64.b64encode(rgba.tobytes()).decode(),
                                          "height": h, "width": w})
        got = counts()
        check(json.loads(out)["ok"] and got == flash_launches,
              f"server /set_image {h}x{w}: launches { {k: n for k, n in got.items() if n} }")
        emb_body, emb_ms = call("/embedding")
        emb_r = json.loads(emb_body)
        ref = DecoderRef(json.loads(call("/decoder_manifest.json")[0]),
                         call("/decoder_weights.bin")[0])
        emb = np.frombuffer(base64.b64decode(emb_r["embedding"]), np.float32)
        same_emb = np.array_equal(emb.reshape(emb_r["shape"]),
                                  predictor.features.float().cpu().numpy())
        emb = emb.reshape(-1, emb_r["shape"][-1])
        ih, iw = emb_r["input_size"]
        click_ms, equal, iou_gaps, clicks = [], [], [], []
        for x, y, label in SERVER_CLICKS:
            clicks.append((x, y, label))
            out, ms = call("/click", {"x": x, "y": y, "label": label})
            click_ms.append(ms)
            srv = json.loads(out)
            masks, ious, _ = predictor.predict(np.array([c[:2] for c in clicks], np.float32),
                                               np.array([c[2] for c in clicks], np.float32),
                                               multimask_output=False)
            mask = base64.b64decode(srv["mask"])
            equal.append(mask == masks[0].astype(np.uint8).tobytes()
                         and srv["iou"] == float(ious[0]))
            _, iou_js = ref.decode(emb, [(cx * iw / w, cy * ih / h, lab)
                                         for cx, cy, lab in clicks])
            iou_gaps.append(abs(float(iou_js) - srv["iou"]))
        check(all(equal) and same_emb,
              f"server /click x{len(SERVER_CLICKS)}: masks and IoUs byte-equal to predict "
              f"({equal}); /embedding equal to the predictor's features as float32 {same_emb}")
        check(max(iou_gaps) <= DECODER_REF_TOL,
              f"server: demo/decoder_ref.py on the served blob and embedding, IoU vs /click "
              f"max |d| {max(iou_gaps):.2e} (<= {DECODER_REF_TOL})")
        print(f"server round trips: /set_image {set_ms:.2f} ms, /click "
              + " / ".join(f"{ms:.2f}" for ms in click_ms)
              + f" ms, /embedding {emb_ms:.2f} ms ({len(emb_body)} bytes)  [{card}]")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    del predictor, model
    torch.cuda.empty_cache()

    # (e) ViT-H RTN W4 g128, bf16.
    model = vit_h()
    seq.rtn_quantize_encoder(model.image_encoder, seq.GPTQConfig(bits=4, groupsize=128))
    model.image_encoder.to(torch.bfloat16)
    gen = Generator(model, points_per_side=AMG_SIDE, points_per_batch=AMG_BATCH,
                    output_mode="uncompressed_rle", **AMG_OFF)
    reset_counts()
    anns, split = generate(gen, images[0])
    got = counts()
    report(f"ViT-H W4 bf16 {AMG_SIDE}x{AMG_SIDE} thresholds off", anns, split)
    check(got == w4_launches and split["nms_in"] == [n_masks] and areas_ok(anns),
          f"AMG ViT-H W4: launches { {k: n for k, n in got.items() if n} }, {len(anns)} kept, "
          f"areas their masks' sums")
    del model, gen, anns
    torch.cuda.empty_cache()
    print(f"AMG and server phase: {time.perf_counter() - phase_t:.1f} s")


def _clicks(seed: int, n: int, size: int):
    """``n`` seeded click lists of 1 to 3 points (x, y, label) in a model frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = 1 + i % 3
        out.append((rng.uniform(32, size - 32, size=(k, 2)).astype(np.float32),
                    np.array([1.0, 0.0, 1.0][:k], np.float32)))
    return out


def _sp_grad_gap(dev, group, batch: int, seq_len: int) -> float:
    """Largest |d| between sp_attention's float32 gradients of sum(out * w)
    (q, k, v, rel_h, rel_w at ViT-H's global head shape) over ``group`` and
    sp_attention_reference's, on seeded inputs the same on every rank."""
    import torch

    from sam_quantization_tpu_torch.parallel import sp_attention as sp_lib

    g = torch.Generator(device=dev).manual_seed(11)
    shapes = [(batch, 16, seq_len, 80)] * 3 + [(batch, 16, seq_len, 64)] * 2
    ins = [torch.randn(s, generator=g, device=dev) for s in shapes]
    w = torch.randn(shapes[0], generator=g, device=dev)
    grads = []
    for fn in (lambda *a: sp_lib.sp_attention(*a, 80**-0.5, group),
               lambda *a: sp_lib.sp_attention_reference(*a, 80**-0.5)):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        grads.append(torch.autograd.grad((fn(*leaves) * w).sum(), leaves))
    return max(float((a - b).abs().max()) for a, b in zip(*grads))


def _two_rank_world(rank: int, port: int, results, backend: str = "nccl",
                    name: str = "vit_h") -> None:
    """One rank of a two-rank world (NCCL on two cards): the tp 2 encoder of
    ``name`` against the unsharded one, dense and W4A8 (sym g128); the dp 2
    step against the one-process step on the full batch; sp_attention's
    gradients against the reference's. Rank 0 puts its readings on
    ``results``."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.parallel import distributed, mesh as mesh_lib
    from sam_quantization_tpu_torch.quant import sequential as seq
    from sam_quantization_tpu_torch.train import trainer as trainer_lib

    dev = distributed.initialize(backend, init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=2, rank=rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = build_sam.sam_model_registry[name](device=dev, seed=0)
        size = model.config.image_encoder.img_size
        x = torch.randn(1, size, size, 3, generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
        with torch.no_grad():
            ref = model.image_encoder(x, "eager")
            tp2 = mesh_lib.make_mesh(tp=2)
            mesh_lib.shard_params(model, tp2)
            with mesh_lib.tensor_parallel(tp2):
                out = model.image_encoder(x)
        tp_err = float((out - ref).norm() / ref.norm())
        del model, ref, out

        enc = build_sam.sam_model_registry[name](device=dev, seed=0).image_encoder
        seq.rtn_quantize_encoder(enc, seq.GPTQConfig(bits=4, groupsize=128, sym=True))
        enc = packed_lib.with_act_bits(enc, 8)
        with torch.no_grad():
            ref = enc(x, "eager")
            mesh_lib.shard_params(enc, tp2)
            with mesh_lib.tensor_parallel(tp2):
                out = enc(x)
        a8_err = float((out - ref).norm() / ref.norm())
        del enc, ref, out
        sp_err = _sp_grad_gap(dev, mesh_lib.group_of(tp2), 1, 4096)

        tcfg = trainer_lib.TrainConfig(num_clicks=2)
        scenes = list(synthetic_samples(2, size, 0))
        images = torch.from_numpy(np.concatenate([im for im, _ in scenes])).to(dev)
        gts = torch.from_numpy(np.stack([gt for _, gt in scenes]).astype(np.float32)).to(dev)
        coords = torch.tensor([[[0.3 * size, 0.4 * size], [0.7 * size, 0.5 * size]]] * 2,
                              device=dev)
        labels = torch.tensor([[1.0, 0.0]] * 2, device=dev)
        params = []
        for mesh, rows in ((None, slice(0, 2)), (mesh_lib.make_mesh(tp=1), slice(rank, rank + 1))):
            model = build_sam.sam_model_registry[name](device=dev, seed=0)
            opt = trainer_lib.make_optimizer(tcfg, model)
            trainer_lib.make_train_step(tcfg, opt, mesh)(
                model, images[rows], gts[rows], None, clicks=(coords[rows], labels[rows]))
            params.append(torch.cat([p.detach().reshape(-1) for p in model.parameters()]))
            del model, opt
        dp_err = float((params[1] - params[0]).norm() / params[0].norm())
        if rank == 0:
            results.put((tp_err, dp_err, a8_err, sp_err))
    finally:
        distributed.destroy()


def parallel_phase(dev, card: str, build, reset_counts, counts, flash_launches: dict,
                   train_launches: dict, mode_launches: dict) -> None:
    """The parallel package (module docstring, step 17): (a) batched encodes
    through the kernels, dense and each quantized serving mode
    (``mode_launches``: a ViT-H image's launches in W4, W4A8 and cached
    int8); (b) ``SamServer`` with client threads; (c) a one-rank NCCL world;
    (d) a two-rank one where there are two cards."""
    import threading

    import numpy as np
    import torch

    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.quant import act_scales as act_lib
    from sam_quantization_tpu_torch.quant import sequential as seq
    from sam_quantization_tpu_torch.parallel import distributed
    from sam_quantization_tpu_torch.parallel import mesh as mesh_lib
    from sam_quantization_tpu_torch.parallel import sp_attention as sp_lib
    from sam_quantization_tpu_torch.parallel.serving import (
        MultiHostSamServer, SamServer, _pack_requests, _request, run_batch)
    from sam_quantization_tpu_torch.train import trainer as trainer_lib

    phase_t = time.perf_counter()
    model = build()
    size = model.config.image_encoder.img_size
    rng = np.random.default_rng(17)
    images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8).astype(np.float32)
              for _ in range(SERVER_REQUESTS)]
    clicks = _clicks(17, SERVER_REQUESTS, size)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # (a) Batched encode, bf16, B = 4 against four B = 1.
    model.image_encoder.to(torch.bfloat16)
    x = sam_lib.preprocess(model, torch.from_numpy(np.stack(images[:4])).to(dev))
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        sam_lib.encode_image(model, x)  # warm-up at this batch size
        sam_lib.encode_image(model, x[:1])
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        batched = sam_lib.encode_image(model, x).float()
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t) * 1e3
        got = counts()
        singles, single_ms, ok_counts = [], [], True
        for i in range(4):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            singles.append(sam_lib.encode_image(model, x[i:i + 1]).float())
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t) * 1e3)
            ok_counts &= counts() == flash_launches
    errs = [float((batched[i] - singles[i][0]).norm() / singles[i][0].norm()) for i in range(4)]
    check(got == flash_launches and ok_counts and max(errs) <= BATCH_TOL
          and bool(torch.isfinite(batched).all()),
          f"batched encode ViT-H bf16 B=4: launches {got} (28/4 per batch, and per B=1 encode "
          f"{ok_counts}); rel L2 vs B=1 {max(errs):.3e} (<= {BATCH_TOL})")
    print(f"  batched encode: B=4 {batch_ms:.2f} ms vs 4 x B=1 {sum(single_ms):.2f} ms "
          f"({', '.join(f'{m:.2f}' for m in single_ms)})  [{card}]")
    del batched, singles, x

    # B = 8 through each quantized serving mode's kernels (the packed and
    # W-A8 kernels see 8x the rows, the attention kernels 200 windows and
    # 128 global heads, the int8-out epilogue 8x its rows).
    def batched(encoder, want, x8):
        with torch.inference_mode():
            encoder(x8), encoder(x8[:1])  # warm-up at both batch sizes
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = encoder(x8).float()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            got, each, one_ms = counts(), True, 0.0
            errs = []
            for i in range(len(x8)):
                reset_counts()
                t = time.perf_counter()
                one = encoder(x8[i:i + 1]).float()[0]
                torch.cuda.synchronize()
                one_ms += (time.perf_counter() - t) * 1e3
                each &= counts() == want
                errs.append(float((out[i] - one).norm() / one.norm()))
        return got == want and each, max(errs), ms, one_ms, got

    x8 = sam_lib.preprocess(model, torch.from_numpy(np.stack(images[:8])).to(dev))
    x8 = x8.to(torch.bfloat16)
    w4 = None
    for mode in ("W4", "W4A8", "cached int8"):
        enc = build().image_encoder
        if mode == "cached int8":
            calib = copy.deepcopy(enc).to(torch.bfloat16)
            act = act_lib.calibrate_act_scales(calib, [x8[:1]], margin=1.1)
            del calib
        seq.rtn_quantize_encoder(enc, seq.GPTQConfig(bits=4, groupsize=128, sym=mode != "W4"))
        if mode == "W4A8":
            enc = packed_lib.with_act_bits(enc, 8)
        if mode == "cached int8":
            packed_lib.cache_int8(enc, act_scales=act,
                                  skip=packed_lib.default_serve_skip(enc.cfg.embed_dim))
        enc.to(torch.bfloat16)
        ok, err, ms, one_ms, got = batched(enc, mode_launches[mode], x8)
        check(ok and err <= BATCH_TOL,
              f"batched encode ViT-H {mode} bf16 B=8: launches per batch = per image "
              f"{ {n: c for n, c in got.items() if c} }; rel L2 vs B=1 {err:.3e} "
              f"(<= {BATCH_TOL})")
        print(f"  batched encode {mode}: B=8 {ms:.2f} ms vs 8 x B=1 {one_ms:.2f} ms  [{card}]")
        if mode == "W4":
            w4 = enc
        del enc
    del x8
    torch.cuda.empty_cache()

    # (b) SamServer: max_batch 8 and 1, 4 client threads, 16 requests.
    alone = []
    with torch.inference_mode():
        for img, (pts, lbl) in zip(images, clicks):
            low, iou = run_batch(model, *_pack_requests([_request(img, pts, lbl)], 1, size))
            alone.append((low[0], iou[0]))
    readings = {}
    for max_batch in (1, SERVER_BATCH):
        server = SamServer(model, max_batch=max_batch, max_wait_ms=SERVER_WAIT_MS)
        server.start()
        server.submit(images[0], *clicks[0]).result(timeout=120)  # warm-up
        server.batch_sizes.clear()
        torch.cuda.reset_peak_memory_stats()
        latency = [None] * SERVER_REQUESTS
        futures = [None] * SERVER_REQUESTS

        def client(c):
            for i in range(c, SERVER_REQUESTS, SERVER_CLIENTS):
                t0 = time.perf_counter()
                f = server.submit(images[i], *clicks[i])
                f.add_done_callback(lambda _, i=i, t0=t0: latency.__setitem__(
                    i, (time.perf_counter() - t0) * 1e3))
                futures[i] = f

        t = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVER_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        results = [f.result(timeout=300) for f in futures]
        wall = time.perf_counter() - t
        server.stop()
        peak = torch.cuda.max_memory_allocated() / 2**30
        low_err = max(rel(r[0], a[0]) for r, a in zip(results, alone))
        iou_err = max(float(np.abs(r[1] - a[1]).max()) for r, a in zip(results, alone))
        lat = sorted(latency)
        readings[max_batch] = (SERVER_REQUESTS / wall, lat, list(server.batch_sizes), peak)
        check(all(f.done() and f.exception() is None for f in futures)
              and low_err <= BATCH_TOL and iou_err <= BATCH_TOL,
              f"SamServer max_batch {max_batch}: {SERVER_REQUESTS} futures resolved; vs each "
              f"request alone: low-res rel L2 {low_err:.3e}, |IoU| {iou_err:.3e} "
              f"(<= {BATCH_TOL})")
    for max_batch, (ips, lat, sizes, peak) in readings.items():
        print(f"  SamServer max_batch {max_batch} (max_wait {SERVER_WAIT_MS} ms, "
              f"{SERVER_CLIENTS} clients, {SERVER_REQUESTS} requests, ViT-H bf16): "
              f"{ips:.2f} images/s, latency min {lat[0]:.1f} p50 {lat[len(lat) // 2]:.1f} "
              f"p95 {lat[int(0.95 * (len(lat) - 1))]:.1f} max {lat[-1]:.1f} ms, "
              f"{len(sizes)} batches {sizes}, peak memory {peak:.2f} GiB  [{card}]")
    # Where a served batch of 8 spends its time: the host packing, then one
    # run_batch profiled by part (preprocess with the image copy, encode,
    # decode).
    reqs = [_request(images[i], *clicks[i]) for i in range(SERVER_BATCH)]
    t = time.perf_counter()
    packed = _pack_requests(reqs, SERVER_BATCH, size)
    print(f"  SamServer batch of {SERVER_BATCH}: host packing {(time.perf_counter() - t) * 1e3:.2f} "
          f"ms  [{card}]")
    with torch.inference_mode():
        print_device_profile(f"SamServer batch of {SERVER_BATCH} (run_batch)",
                             lambda: run_batch(model, *packed),
                             ranges=((sam_lib, "preprocess", "preprocess"),
                                     (sam_lib, "encode_image", "encode"),
                                     (sam_lib, "decode_masks", "decode")))
    del packed, reqs

    # (c) A one-rank NCCL world.
    distributed.initialize("nccl", init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
                           world_size=1, rank=0)
    try:
        mesh = mesh_lib.make_mesh(tp=1)
        loss = {"iou": 0.25, "loss": 1.5}
        check(distributed.reduce_loss_dict(loss) == loss, "one-rank NCCL: reduce_loss_dict "
                                                          "returns its input")
        g = torch.Generator(device=dev).manual_seed(9)
        q, k, v = (torch.randn(1, 16, 4096, 80, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        rh, rw = (torch.randn(1, 16, 4096, 64, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        with torch.inference_mode():
            out = sp_lib.sp_attention(q, k, v, rh, rw, 80**-0.5, mesh_lib.group_of(mesh))
            ref = sp_lib.sp_attention_reference(q, k, v, rh, rw, 80**-0.5)
        check(torch.equal(out, ref), "one-rank NCCL: sp_attention (1, 16, 4096, 80) bf16 "
                                     f"equals sp_attention_reference (max|d| "
                                     f"{float((out.float() - ref.float()).abs().max()):.3e})")
        del q, k, v, rh, rw, out, ref

        # MultiHostSamServer: one tick serves two requests, as SamServer's batch.
        srv = MultiHostSamServer(model, mesh, per_host_batch=2)
        futs = [srv.submit(images[i], *clicks[i]) for i in range(2)]
        served = srv.tick()
        with torch.inference_mode():
            want = run_batch(model, *_pack_requests(
                [_request(images[i], *clicks[i]) for i in range(2)], 2, size))
        diff = max(float(np.abs(f.result()[j] - want[j][i]).max())
                   for i, f in enumerate(futs) for j in range(2))
        check(served == 2 and srv.tick() == 0 and diff == 0.0,
              f"one-rank NCCL: MultiHostSamServer tick served {served}, results equal "
              f"SamServer's batch (max|d| {diff:.3e}); an empty tick serves 0")
        del model
        torch.cuda.empty_cache()

        # ViT-H float32 under tensor_parallel at tp 1 against the eager encoder.
        model = build()
        x = torch.randn(1, size, size, 3, generator=g, device=dev)
        with torch.inference_mode():
            ref = model.image_encoder(x, "eager")
        mesh_lib.shard_params(model, mesh)
        with torch.inference_mode(), mesh_lib.tensor_parallel(mesh):
            reset_counts()
            out = model.image_encoder(x)
            torch.cuda.synchronize()
        tp_err = float((out - ref).norm() / ref.norm())
        launched = {n: c for n, c in counts().items() if c}
        check(tp_err <= TP1_TOL and not launched,
              f"one-rank NCCL: ViT-H f32 encoder under tensor_parallel (tp 1) vs eager: rel L2 "
              f"{tp_err:.3e} (<= {TP1_TOL}), kernel launches {launched or 'none'}")
        del model, x, ref, out
        torch.cuda.empty_cache()

        # The W4 ViT-H (g128) in float32 under tensor_parallel at tp 1: the
        # per-linear route (no fused MLP) on its row and column shards.
        w4.to(torch.float32)
        x = torch.randn(1, size, size, 3, generator=g, device=dev)
        with torch.inference_mode():
            ref = w4(x, "eager")
        mesh_lib.shard_params(w4, mesh)
        with torch.inference_mode(), mesh_lib.tensor_parallel(mesh):
            reset_counts()
            out = w4(x)
            torch.cuda.synchronize()
        tp_err = float((out - ref).norm() / ref.norm())
        launched = {n: c for n, c in counts().items() if c}
        check(tp_err <= TP1_TOL and launched == {"quant_matmul": 128},
              f"one-rank NCCL: ViT-H W4 f32 encoder under tensor_parallel (tp 1) vs its eager "
              f"path: rel L2 {tp_err:.3e} (<= {TP1_TOL}), launches {launched}")
        del w4, x, ref, out
        torch.cuda.empty_cache()

        # Step 18 (c): the W4A8 ViT-H (sym g128) in float32 under
        # tensor_parallel at tp 1, proj's and lin2's row shards quantizing at
        # the token amax all-reduced over the group; and sp_attention's
        # gradient at the global shape against the reference's.
        a8 = build().image_encoder
        seq.rtn_quantize_encoder(a8, seq.GPTQConfig(bits=4, groupsize=128, sym=True))
        a8 = packed_lib.with_act_bits(a8, 8)
        x = torch.randn(1, size, size, 3, generator=g, device=dev)
        with torch.inference_mode():
            ref = a8(x, "eager")
        mesh_lib.shard_params(a8, mesh)
        with torch.inference_mode(), mesh_lib.tensor_parallel(mesh):
            reset_counts()
            out = a8(x)
            torch.cuda.synchronize()
        tp_err = float((out - ref).norm() / ref.norm())
        launched = {n: c for n, c in counts().items() if c}
        group = mesh_lib.group_of(mesh)
        with torch.inference_mode():
            same = []
            for layer in (a8.blocks[0].attn.proj, a8.blocks[0].mlp.lin2):
                h = torch.randn(4096, layer.in_features, generator=g, device=dev)
                same.append(torch.equal(mesh_lib.row_parallel(layer, h, group), layer(h)))
        check(tp_err <= A8_F32_TOL and launched == {"quant_matmul_a8_sym": 128} and all(same),
              f"one-rank NCCL: ViT-H W4A8 f32 encoder under tensor_parallel (tp 1) vs its eager "
              f"path: rel L2 {tp_err:.3e} (<= {A8_F32_TOL}: int8 flips cascading from the TP "
              f"attention's float order), launches {launched}; block 0's proj and lin2 row "
              f"shards on one input equal their layers bit for bit: {same}")
        del a8, x, ref, out
        torch.cuda.empty_cache()
        sp_err = _sp_grad_gap(dev, mesh_lib.group_of(mesh), 1, 4096)
        check(sp_err <= SP_GRAD_TOL, "one-rank NCCL: sp_attention (1, 16, 4096, 80) f32 "
                                     f"gradients of q, k, v, rel_h, rel_w vs the reference's: "
                                     f"max|d| {sp_err:.3e} (<= {SP_GRAD_TOL})")

        # One ViT-H float32 dp step, clicks given, against the plain step.
        model = build()
        trainer_lib.trainable_parameters(model)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        im, gt = next(iter(synthetic_samples(1, size, 5)))
        img = torch.from_numpy(im).to(dev)
        gt = torch.from_numpy(gt[None].astype(np.float32)).to(dev)
        given = (torch.tensor([[[0.3 * size, 0.4 * size], [0.7 * size, 0.5 * size]]], device=dev),
                 torch.tensor([[1.0, 0.0]], device=dev))
        tcfg = trainer_lib.TrainConfig(num_clicks=2)
        after, step_counts, step_cost = {}, {}, {}
        for tag, step_mesh in (("plain", None), ("dp", mesh), ("plain again", None)):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(start[n])
            opt = trainer_lib.make_optimizer(tcfg, model)
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            trainer_lib.make_train_step(tcfg, opt, step_mesh)(model, img, gt, None, clicks=given)
            torch.cuda.synchronize()
            # host clock with a synchronize; the step's peak above what was held before it
            step_cost[tag] = ((time.perf_counter() - t0) * 1e3,
                              (torch.cuda.max_memory_allocated() - held) / 2**30)
            step_counts[tag] = counts()
            after[tag] = {n: p.detach().clone() for n, p in model.named_parameters()}
            del opt
        same = all(torch.equal(after["plain"][n], after["dp"][n]) for n in start)
        moved = sum(not torch.equal(after["dp"][n], start[n]) for n in start)
        note = "" if same else (
            "; the plain step against itself: bit-equal "
            f"{all(torch.equal(after['plain'][n], after['plain again'][n]) for n in start)}")
        check(same and moved > 0.8 * len(start) and step_counts["dp"] == train_launches,
              f"one-rank NCCL: ViT-H f32 dp step (2 clicks given) equals the plain step bit for "
              f"bit: {same} ({moved} of {len(start)} leaves moved; launches "
              f"{ {n: c for n, c in step_counts['dp'].items() if c} }){note}")
        print("  one-rank NCCL ViT-H f32 step (2 clicks given), ms / peak GiB above the "
              "model's: " + ", ".join(f"{tag} {ms:.2f} / {gib:.2f}"
                                      for tag, (ms, gib) in step_cost.items())
              + f"  [{card}]")
        del model, start, after
        torch.cuda.empty_cache()
    finally:
        distributed.destroy()
    worlds = ["one-rank NCCL"]

    # (d) Two cards: a two-rank NCCL world.
    if torch.cuda.device_count() >= 2:
        import torch.multiprocessing as mp

        results = mp.get_context("spawn").SimpleQueue()
        mp.spawn(_two_rank_world, args=(distributed.free_port(), results), nprocs=2)
        tp_err, dp_err, a8_err, sp_err = results.get()
        check(tp_err <= TP2_TOL and dp_err <= DP2_TOL and a8_err <= A8_TP2_TOL
              and sp_err <= SP_GRAD_TOL,
              f"two-rank NCCL: ViT-H f32 tp 2 encoder vs tp 1 rel L2 {tp_err:.3e} "
              f"(<= {TP2_TOL}), W4A8 {a8_err:.3e} (<= {A8_TP2_TOL}); dp 2 step vs one "
              f"process, parameters rel L2 {dp_err:.3e} (<= {DP2_TOL}); sp_attention "
              f"gradients vs the reference max|d| {sp_err:.3e} (<= {SP_GRAD_TOL})")
        worlds.append("two-rank NCCL")
    print(f"parallel worlds run: {', '.join(worlds)} ({torch.cuda.device_count()} card(s)); "
          f"phase {time.perf_counter() - phase_t:.1f} s")


class _Clicks:
    """A fixed list of clicks in a clicker's interface (``get_clicks``), to
    replay one device's clicks on the other."""

    def __init__(self, clicks):
        self.clicks = list(clicks)

    def get_clicks(self, clicks_limit=None):
        return self.clicks[:clicks_limit]


def classifier_brs_phase(dev, card: str, build, reset_counts, counts, zero: dict,
                         flash_launches: dict) -> None:
    """Classifiers and BRS (module docstring, step 18): (a) DeiT-B and Swin-T
    at full width, card against CPU, and ``cli.test_quant``; (b) the BRS
    predictors, vit_tiny_synth card against CPU and ViT-H float32 through
    the kernels, and ``cli.evaluate --mode InputBRS``."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.cli import evaluate as evaluate_cli
    from sam_quantization_tpu_torch.cli import test_quant as test_quant_cli
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.evaluation import lbfgs
    from sam_quantization_tpu_torch.evaluation.clicker import Click, Clicker
    from sam_quantization_tpu_torch.evaluation.predictors import (
        FeatureBRSPredictor, InputBRSPredictor)
    from sam_quantization_tpu_torch.models import build_sam, swin_classifier, vit_classifier
    from sam_quantization_tpu_torch.predictor import SamPredictor
    from sam_quantization_tpu_torch.quant.fq import pipeline as fq
    from sam_quantization_tpu_torch.quant.sequential import full_float32
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib

    phase_t = time.perf_counter()
    repo = pathlib.Path(__file__).resolve().parent

    def rel(a, b):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return float((a - b).norm() / b.norm())

    def card_ms(fn, n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)

    # (a) DeiT-B and Swin-T, seeded weights, float32, batch CLF_BATCH.
    fq_cfg = fq.FQConfig()
    Points = _points_ctx()
    rng = np.random.default_rng(18)
    reset_counts()
    for name, mod, cfg in (
            ("deit_base", vit_classifier, vit_classifier.CLASSIFIER_CONFIGS["deit_base"]),
            ("swin_tiny", swin_classifier, swin_classifier.SWIN_CONFIGS["swin_tiny"])):
        t0 = time.perf_counter()
        on_cpu = mod.init(cfg, seed=0, device="cpu")
        on_card = copy.deepcopy(on_cpu).to(dev)
        xs = [torch.from_numpy(rng.normal(size=(CLF_BATCH, cfg.img_size, cfg.img_size, 3))
                               .astype(np.float32)) for _ in range(3)]
        with torch.no_grad(), full_float32():
            f_cpu = on_cpu(xs[2])
            f_card = on_card(xs[2].to(dev))
            f_ms = card_ms(lambda: on_card(xs[2].to(dev)))
        q_card = fq.calibrate(lambda x, ctx: on_card(x, ctx), [x.to(dev) for x in xs[:2]],
                              fq_cfg)
        q_cpu = fq.calibrate(lambda x, ctx: on_cpu(x, ctx), xs[:2], fq_cfg)
        layer = [k for k, (sc, _) in q_cpu.items() if sc.ndim == 0]
        ptf = [k for k in q_cpu if k not in layer]
        gap = max(float(((q_card[k][0].cpu() - q_cpu[k][0]).abs() / q_cpu[k][0]).max())
                  for k in q_cpu)
        zeros_equal = all(torch.equal(q_card[k][1].cpu(), q_cpu[k][1]) for k in q_cpu)
        factors = [tuple(torch.round(sc / sc.min()) for sc in (q_card[k][0].cpu(), q_cpu[k][0]))
                   for k in ptf]
        same = sum(int((a == b).sum()) for a, b in factors)
        total = sum(a.numel() for a, _ in factors)
        qm_cpu, qm_card = fq.fq_quantize_weights(on_cpu, fq_cfg), fq.fq_quantize_weights(on_card,
                                                                                        fq_cfg)
        w_equal = all(torch.equal(a.cpu(), b) for a, b in
                      zip(qm_card.state_dict().values(), qm_cpu.state_dict().values()))
        # the quant mode held point by point, as step 16 holds SAM's encoder
        on = {k: (sc.to(dev), z.to(dev)) for k, (sc, z) in q_cpu.items()}
        with torch.no_grad(), full_float32():
            cpu = Points(None, "quant", fq_cfg, qparams=q_cpu)
            l_cpu = qm_cpu(xs[2], cpu)
            free = Points(None, "quant", fq_cfg, qparams=on)
            l_card = qm_card(xs[2].to(dev), free)
            forced = Points({p: (cpu.inputs[p], cpu.outputs[p]) for p in cpu.outputs}, "quant",
                            fq_cfg, qparams=on)
            qm_card(xs[2].to(dev), forced)
            q_ms = card_ms(lambda: qm_card(xs[2].to(dev), fq.FQCtx("quant", fq_cfg, qparams=on)))
        flips, in_gap, quant_err, cascade, free_ok = _held_points(
            cpu, free, forced, on, l_card, l_cpu, CLF_QUANT_TOL, CLF_CASCADE_TOL)
        # LIS outputs are 2**-k or 0: a flip from the device's log2 rounding
        # is one such step (a factor of 2, or 0 at the 4-bit cutoff)
        lis = [p for p in cpu.outputs if p.endswith(".softmax")]
        lis_values = sum(cpu.outputs[p].numel() for p in lis)
        one_step = True
        for p in flips:
            a, b = forced.outputs[p], cpu.outputs[p]
            d = a != b
            ratio = (a[d] / b[d].clamp(min=1e-30)).log2().abs()
            one_step &= bool((((ratio - 1).abs() < 1e-6) | (a[d] == 0) | (b[d] == 0)).all())
        lis_ok = (set(flips) <= set(lis) and one_step
                  and sum(flips.values()) <= CLF_LIS_FLIP_SHARE * lis_values)
        float_err = rel(f_card, f_cpu)
        check(sorted(q_card) == sorted(q_cpu) and gap <= FQ_SCALE_RTOL and zeros_equal
              and same >= FQ_PTF_SHARE * total and w_equal and float_err <= CLF_FLOAT_TOL
              and lis_ok and in_gap <= FQ_GAP_TOL and free_ok
              and free.ln_modes == cpu.ln_modes and bool(torch.isfinite(l_card).all()),
              f"{name} (f32, batch {CLF_BATCH}) card vs CPU: logits rel L2 {float_err:.3e} "
              f"(<= {CLF_FLOAT_TOL}); FQ calibration over 2 batches: {len(q_card)} points, "
              f"scales' largest rel gap {gap:.2e} (<= {FQ_SCALE_RTOL}), zeros equal "
              f"{zeros_equal}, PTF factors equal on {same}/{total}; weights bit-equal "
              f"{w_equal}; quant mode on the CPU's qparams, each stretch between points fed "
              f"the CPU's input: {len(cpu.outputs)} points' outputs differ in "
              f"{sum(flips.values())} values, at {flips or 'none'} (LIS points only, one step "
              f"each {one_step}, <= {CLF_LIS_FLIP_SHARE:.0e} of {lis_values} LIS values), "
              f"inputs between points rel gap <= {in_gap:.2e} (<= {FQ_GAP_TOL}); free running "
              f"logits rel L2 {quant_err:.3e} (<= {CLF_QUANT_TOL}, or a cascade <= "
              f"{CLF_CASCADE_TOL}: {cascade}); LNs {sorted(set(free.ln_modes.values()))}")
        print(f"  {name} on the card, batch {CLF_BATCH}: float32 forward {f_ms[1]:.2f} ms "
              f"(min {f_ms[0]:.2f}), quant-mode {q_ms[1]:.2f} ms (min {q_ms[0]:.2f}); "
              f"{time.perf_counter() - t0:.1f} s with the CPU side  [{card}]")
        del on_cpu, on_card, qm_cpu, qm_card
    for name in ("deit_base", "swin_tiny"):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = test_quant_cli.main([name, "--calib-iter", "2", "--val-batches", "1"])
        last = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and last["model"] == name and 0.0 <= last["fp_agreement_top1"]
              <= last["fp_agreement_top5"] <= 1.0,
              f"cli.test_quant {name} --calib-iter 2 --val-batches 1 on the card "
              f"({time.perf_counter() - t0:.1f} s): {json.dumps(last)}")
    got = counts()
    check(got == zero, "classifiers, FQ and cli.test_quant launched no kernel: "
                       f"{ {n: c for n, c in got.items() if c} or 'none'}")
    torch.cuda.empty_cache()

    # (b) BRS. vit_tiny_synth, float32 through the kernels, card vs CPU on
    # the CPU's clicks (the second placed on its first map).
    tiny = build_sam.sam_model_registry["vit_tiny"](device="cpu")
    ckpt = repo / "checkpoints" / "vit_tiny_synth"
    ckpt_lib.load_weights(str(ckpt), tiny, "best")
    tiny_card = copy.deepcopy(tiny).to(dev)
    image, gt = next((img[0, :150].astype(np.uint8), g[:150])
                     for img, g in synthetic_samples(1, 200, seed=5))
    for cls, default in ((InputBRSPredictor, 10), (FeatureBRSPredictor, 15)):
        for opt_steps in (2, default):
            cpu = cls(SamPredictor(tiny), opt_steps=opt_steps)
            cpu.set_input_image(image)
            clicker, pred = Clicker(gt_mask=gt), np.zeros(gt.shape, bool)
            for _ in range(2):
                clicker.make_next_click(pred)
                want = cpu.get_prediction(clicker)
                pred = want > 0.5
            on_card = cls(SamPredictor(tiny_card), opt_steps=opt_steps)
            on_card.set_input_image(image)
            got = on_card.get_prediction(_Clicks(clicker.get_clicks()))
            gap = float(np.abs(got - want).max())
            iou = float(((got > 0.5) & (want > 0.5)).sum() / max(((got > 0.5) | (want > 0.5)).sum(), 1))
            tol = BRS_CARD_TOL if opt_steps == 2 else BRS_CARD_DEFAULT_TOL
            check(gap <= tol and len(on_card.last_steps) == len(cpu.last_steps),
                  f"vit_tiny_synth {cls.__name__} opt_steps {opt_steps}, card vs CPU (2 clicks): "
                  f"max |d prob| {gap:.3e} (<= {tol}), mask IoU {iou:.4f}; steps "
                  f"{len(on_card.last_steps)} / {len(cpu.last_steps)}; losses card "
                  f"{[round(s.value_after, 5) for s in on_card.last_steps]} CPU "
                  f"{[round(s.value_after, 5) for s in cpu.last_steps]}")
    del tiny, tiny_card

    # ViT-H float32 through the kernels: one set_image (28/4 launches), then
    # each BRS predictor at its default steps on the clicker's first click,
    # and on it with a positive and a negative click two pixels apart, which
    # fall in one low-res cell: their hinges pull that logit both ways, so
    # L-BFGS must drive it to 0 against the rest of the map.
    model = build()
    size = model.config.image_encoder.img_size
    scene, scene_gt = next(iter(synthetic_samples(1, size, 18)))
    scene = np.clip(scene[0], 0, 255).astype(np.uint8)
    first = Clicker(gt_mask=scene_gt)
    first.make_next_click(np.zeros(scene_gt.shape, bool))
    c = size // 2
    plans = (first.get_clicks(), first.get_clicks() + [Click(is_positive=True, coords=(c, c)),
                                                         Click(is_positive=False, coords=(c, c + 2))])
    for cls in (InputBRSPredictor, FeatureBRSPredictor):
        brs = cls(SamPredictor(model))
        reset_counts()
        brs.set_input_image(scene)
        torch.cuda.synchronize()
        encode_counts = counts()
        readings, ok = [], True
        for clicks in plans:
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            prob = brs.get_prediction(_Clicks(clicks))
            ms = (time.perf_counter() - t) * 1e3
            launched = counts()
            steps = brs.last_steps
            rises = [s for s in steps if s.decrease_error == 0.0
                     and s.value_after - s.value > lbfgs.APPROX_DEC_RTOL * abs(s.value)]
            ok &= (launched == zero and not rises and 1 <= len(steps) <= brs.opt_steps
                   and np.isfinite(prob).all() and prob.shape == scene_gt.shape)
            readings.append((ms, steps))
        check(ok and encode_counts == flash_launches and len(readings[1][1]) >= 2,
              f"ViT-H f32 {cls.__name__} (opt_steps {brs.opt_steps}): set_image launches "
              f"{ {n: c for n, c in encode_counts.items() if c} } (28/4); get_prediction "
              "launches no kernel; the conflicting pair takes 2 steps or more; no step with "
              "sufficient decrease raised the loss")
        for i, (ms, steps) in enumerate(readings):
            print(f"  ViT-H {cls.__name__} {('first click', 'with the conflicting pair')[i]}: "
                  f"{ms:.1f} ms, {len(steps)} steps, "
                  f"{sum(s.linesearch_steps for s in steps)} line-search evaluations; loss "
                  f"{steps[0].value:.5g} -> " + ", ".join(f"{s.value_after:.5g}" for s in steps)
                  + f"  [{card}]")
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = evaluate_cli.main(["vit_tiny", "--datasets", "synthetic", "--num-samples", "2",
                                "--n-clicks", "3", "--mode", "InputBRS", "--checkpoint",
                                str(ckpt)])
    table = buf.getvalue()
    check(rc == 0 and "synthetic" in table and "NoC@90%" in table,
          f"cli.evaluate vit_tiny --mode InputBRS on the card ({time.perf_counter() - t0:.1f} s)")
    print(table.rstrip())
    print(f"classifier and BRS phase {time.perf_counter() - phase_t:.1f} s")


def seeded_model(name: str, dev, depth=None):
    """``name`` from seed 0, rel-pos tables drawn from seed 1 (as main's
    vit_h()); ``depth``: its first blocks only."""
    import torch

    from sam_quantization_tpu_torch.models import configs
    from sam_quantization_tpu_torch.models import sam as sam_lib

    cfg = configs.CONFIGS[name]
    if depth is not None:
        ecfg = cfg.image_encoder
        cfg = dataclasses.replace(cfg, image_encoder=dataclasses.replace(
            ecfg, depth=depth,
            global_attn_indexes=tuple(i for i in ecfg.global_attn_indexes if i < depth)))
    m = sam_lib.init(cfg, 0, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for blk in m.image_encoder.blocks:
            for t in (blk.attn.rel_pos_h, blk.attn.rel_pos_w):
                t.copy_(torch.randn(t.shape, generator=g, device=dev) * 0.2)
    return m


def aoti_int8_model(dev):
    """Step 19 (e)'s encoder, (model, image, static scales): the seeded
    AOTI_ENCODER, cached int8 (RTN sym W4 g128, static scales from one
    seeded image, margin 1.1). The same in every process."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.quant import act_scales as act_lib
    from sam_quantization_tpu_torch.quant import sequential as seq

    model = seeded_model(AOTI_ENCODER, dev)
    s_e = model.config.image_encoder.img_size
    x = torch.from_numpy(np.random.default_rng(191).standard_normal((1, s_e, s_e, 3))
                         .astype(np.float32)).to(dev)
    act = act_lib.calibrate_act_scales(model.image_encoder, [x], margin=1.1)
    seq.rtn_quantize_encoder(model.image_encoder, seq.GPTQConfig(bits=4, groupsize=128, sym=True))
    packed_lib.cache_int8(model.image_encoder, act_scales=act,
                          skip=packed_lib.default_serve_skip(model.config.image_encoder.embed_dim))
    return model, x, act


def aoti_package(directory: str) -> int:
    """``python3 chip_smoke.py --aoti-package DIR``: compile step 19 (e)'s
    encoder with AOTInductor for the card into DIR. Step 19 starts it as a
    process of its own, so that the compile (142-183 s, mostly host
    compilers, on an NVIDIA H100 80GB HBM3 machine at 700 W) runs beside the
    rest of steps 19-21."""
    import torch

    from sam_quantization_tpu_torch import export as ex

    model, _, _ = aoti_int8_model(torch.device("cuda"))
    t = time.perf_counter()
    ex.export_encoder_aoti(model, directory)
    print(f"AOTInductor compile {time.perf_counter() - t:.1f} s", flush=True)
    return 0


def export_phase(dev, card: str, build, reset_counts, counts, zero: dict,
                 flash_launches: dict):
    """The export tail (module docstring, step 19), on the float32 ViT-H:
    (b) the ONNX decoder, (d) ``torch.export`` (and the packed vit_tiny
    encoders), (c) the ONNX encoder (ViT-B; ViT-H refused); then (a)'s
    float32 eager forward, and on the bf16 encoder (f) the Profiler and (a)
    ``sam.forward``; and (g) ``cli.export``. (e), the cached-int8 vit_tiny
    AOTInductor package, is compiled by a process of its own
    (:func:`aoti_package`) started first; the returned function waits for
    it and checks the package from Python and by the C++ runner (built in a
    thread beside (b)-(d)). Call it after the steps that follow (20, 21),
    so that the compile runs beside them."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch import export as ex
    from sam_quantization_tpu_torch import export_onnx
    from sam_quantization_tpu_torch.export_onnx import _wire
    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.ops import _build
    from sam_quantization_tpu_torch.ops.quant_matmul import KERNEL_OPS
    from sam_quantization_tpu_torch.predictor import SamPredictor
    from sam_quantization_tpu_torch.quant import sequential as seq
    from sam_quantization_tpu_torch.utils.experiment import Profiler

    phase_t = time.perf_counter()
    repo = pathlib.Path(__file__).resolve().parent
    work = repo / "build" / "chip_export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    aoti_dir = repo / "build" / "chip_aoti"  # (e)'s package, kept until finish_aoti
    shutil.rmtree(aoti_dir, ignore_errors=True)
    aoti_dir.mkdir(parents=True)
    with open(aoti_dir / "compile.log", "w") as log:
        aoti_t = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--aoti-package",
             str(aoti_dir / "aoti_enc")], cwd=repo, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(lambda: child.poll() is None and child.kill())
    seconds = {}
    r = np.random.default_rng(19)

    def rel(a, b):
        a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
        return float((a - b).norm() / b.norm())

    def maxabs(a, b):
        return float((torch.as_tensor(a).double().cpu() - torch.as_tensor(b).double().cpu())
                     .abs().max())

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def run_runner(package, feeds, tag):
        in_dir, out_dir = aoti_dir / f"{tag}_in", aoti_dir / f"{tag}_out"
        in_dir.mkdir()
        out_dir.mkdir()
        for k, v in feeds.items():
            v = v.detach().float().cpu().contiguous().numpy()
            v.tofile(in_dir / f"{k}.bin")
            (in_dir / f"{k}.shape").write_text(" ".join(map(str, v.shape)))
        t = time.perf_counter()
        proc = subprocess.run([str(_build.aoti_runner()), str(package), str(in_dir),
                               str(out_dir)], capture_output=True, text=True, timeout=600)
        ran = time.perf_counter() - t
        if proc.returncode != 0:
            print(proc.stdout[-3000:] + proc.stderr[-3000:])
            return None, ran
        got = {}
        for f in sorted(out_dir.glob("*.bin")):
            shape = tuple(int(x) for x in f.with_suffix(".shape").read_text().split())
            got[f.stem] = torch.from_numpy(np.fromfile(f, np.float32).reshape(shape))
        return got, ran

    # (e)'s runner is a g++ build (about 18 s on the host of an NVIDIA H100
    # 80GB HBM3, 700 W): in a thread beside (b)-(d).
    runner_box = {}

    def build_runner():
        t = time.perf_counter()
        try:
            runner_box["path"] = _build.aoti_runner()
        except RuntimeError as e:
            runner_box["error"] = str(e)
        runner_box["seconds"] = time.perf_counter() - t

    runner_thread = threading.Thread(target=build_runner)
    runner_thread.start()
    try:
        model = build()  # ViT-H float32
        cfg = model.config
        h, w = cfg.prompt_encoder.image_embedding_size
        size = cfg.image_encoder.img_size
        x = torch.from_numpy(r.standard_normal((1, size, size, 3)).astype(np.float32)).to(dev)
        image = r.integers(0, 256, (size, size, 3), dtype=np.uint8)

        # (b) first for its kernel-path embedding: set_image through the
        # float32 kernels, then the ONNX decoder at SAM's widths, built from
        # the card's model and from a CPU copy of its decoder.
        predictor = SamPredictor(model)
        reset_counts()
        _, seconds["(b) set_image"] = timed(lambda: predictor.set_image(image))
        check(counts() == flash_launches, "export (b): kernel-path set_image, 28/4 flash launches")
        emb = predictor.features.float()  # (1, 64, 64, 256)
        blob, seconds["(b) ONNX decoder export"] = timed(
            lambda: export_onnx.export_decoder_onnx(model, num_points=3))
        cpu = sam_lib.Sam(cfg, device="cpu")
        cpu.prompt_encoder.load_state_dict(model.prompt_encoder.state_dict())
        cpu.mask_decoder.load_state_dict(model.mask_decoder.state_dict())
        same_bytes = export_onnx.export_decoder_onnx(cpu, num_points=3) == blob
        del cpu
        rt = export_onnx.runtime.load(blob)
        coords = torch.tensor([[[0.3, 0.4], [0.6, 0.7], [0.8, 0.15]]], device=dev) * size
        labels = torch.tensor([[1.0, 0.0, 1.0]], device=dev)
        module = ex.SamDecoderModule(model).eval()
        errs, mask_in, host = [], torch.zeros(1, 4 * h, 4 * w, 1, device=dev), 0.0
        for has in (0.0, 1.0):
            has_t = torch.full((1,), has, device=dev)
            with torch.no_grad():
                want = module(emb, coords, labels, mask_in, has_t)
            feeds = {"image_embeddings": emb.permute(0, 3, 1, 2), "point_coords": coords,
                     "point_labels": labels, "mask_input": mask_in.permute(0, 3, 1, 2),
                     "has_mask_input": has_t}
            t = time.perf_counter()
            got = rt.run({k: v.cpu().contiguous().numpy() for k, v in feeds.items()})
            host += time.perf_counter() - t
            errs.append([maxabs(got[k], v) for k, v in zip(ex.DECODER_OUTPUTS, want)])
            mask_in = want[2].permute(0, 2, 3, 1).contiguous()  # the next click's mask input
        seconds["(b) numpy runtime, 2 runs"] = host
        worst = [max(e[i] for e in errs) for i in range(3)]
        check(same_bytes and worst[0] <= ONNX_MASK_TOL and worst[1] <= ONNX_IOU_TOL
              and worst[2] <= ONNX_MASK_TOL,
              f"export (b): ONNX decoder ({len(blob)} bytes, 3 points) card bytes == CPU copy's "
              f"bytes {same_bytes}; numpy runtime vs SamDecoderModule on the card, has_mask 0 "
              f"and 1, max |d| masks {worst[0]:.3e} (<= {ONNX_MASK_TOL}), IoU {worst[1]:.3e} "
              f"(<= {ONNX_IOU_TOL}), low-res {worst[2]:.3e}")
        print(f"  ONNX decoder: {len(blob)} bytes, export {seconds['(b) ONNX decoder export']:.2f}"
              f" s, numpy runtime {host / 2:.2f} s a run (host)  [{card}]")
        del rt, blob

        # (d) torch.export: the ViT-H decoder and float32 encoder, saved,
        # loaded and run against the eager module.
        args = (emb, coords, labels, torch.zeros(1, 4 * h, 4 * w, 1, device=dev),
                torch.zeros(1, device=dev))
        shallow = seeded_model("vit_h", dev, EXPORT_ENCODER_DEPTH)
        with torch.no_grad():
            want = module(*args)
            want_enc = sam_lib.encode_image(shallow, x, "eager")
        reset_counts()
        _, seconds["(d) decoder export + save"] = timed(
            lambda: ex.export_decoder(model, str(work / "decoder.pt2"), num_points=3))
        fn, seconds["(d) decoder load"] = timed(lambda: ex.load_exported(str(work / "decoder.pt2")))
        with torch.no_grad():
            got = fn(*args)
        dec_err = max(rel(a, b) for a, b in zip(got, want))
        _, seconds["(d) encoder export + save"] = timed(
            lambda: ex.export_encoder(shallow, str(work / "encoder.pt2")))
        pt2_bytes = (work / "encoder.pt2").stat().st_size
        fn, seconds["(d) encoder load"] = timed(lambda: ex.load_exported(str(work / "encoder.pt2")))
        with torch.no_grad():
            got_enc, seconds["(d) encoder run"] = timed(lambda: fn(x))
        del fn, shallow
        (work / "encoder.pt2").unlink()
        enc_err = rel(got_enc, want_enc)
        check(dec_err <= EXPORT_TOL and enc_err <= EXPORT_TOL and counts() == zero,
              f"export (d): torch.export ViT-H decoder rel L2 {dec_err:.3e}, float32 encoder "
              f"(first {EXPORT_ENCODER_DEPTH} blocks, {pt2_bytes / 1e9:.2f} GB .pt2) rel L2 "
              f"{enc_err:.3e} vs eager (<= {EXPORT_TOL}); no kernel launched")
        del got_enc, want_enc

        # W4 and W4A8 encoders exported on the card hold the kernel ops: no
        # launch while exported, 16 a run of the loaded program; the
        # AOTInductor packager refuses them.
        tiny = build_sam.sam_model_registry["vit_tiny"](device=dev, seed=3)
        seq.rtn_quantize_encoder(tiny.image_encoder,
                                 seq.GPTQConfig(bits=4, groupsize=32, sym=True))
        xt = torch.from_numpy(r.standard_normal((1, 128, 128, 3)).astype(np.float32)).to(dev)
        for act_bits, name in ((0, "quant_matmul"), (8, "quant_matmul_a8_sym")):
            tiny.image_encoder = packed_lib.with_act_bits(tiny.image_encoder, act_bits)
            path = str(work / f"w4a{act_bits}.pt2")
            reset_counts()
            ex.export_encoder(tiny, path)
            exported_counts = counts()
            fn = ex.load_exported(path)
            held = len(ex.kernel_ops_held(torch.export.load(path)))
            with torch.no_grad():
                reset_counts()
                got_w4 = fn(xt)
                run_counts = counts()
                reset_counts()
                want_w4 = sam_lib.encode_image(tiny, xt, "eager")
                eager_counts = counts()
            try:
                ex.export_encoder_aoti(tiny, str(work / "aoti_w4"))
                refused = "not refused"
            except ValueError as e:
                refused = str(e)
            w4_err = rel(got_w4, want_w4)
            check(exported_counts == zero and held == 16 and run_counts[name] == 16
                  and run_counts == eager_counts and w4_err <= EXPORT_TOL
                  and KERNEL_OPS[act_bits // 8] in refused and not (work / "aoti_w4").exists(),
                  f"export (d): W4{'A8' if act_bits else ''} vit_tiny encoder exported on the "
                  f"card holds {held} kernel ops (16), launches {exported_counts[name]} {name} "
                  f"in the export (0) and {run_counts[name]} a run (16, as eager: "
                  f"{eager_counts[name]}); rel L2 vs eager {w4_err:.3e} (<= {EXPORT_TOL}); "
                  f"AOTInductor: {refused[:90]}")
        del tiny, fn


        # (c) ViT-H's float32 encoder is past protobuf's 2 GiB: refused
        # before anything is built.
        t = time.perf_counter()
        try:
            export_onnx.export_encoder_onnx(model)
            refused = "not refused"
        except ValueError as e:
            refused = str(e)
        refuse_ms = (time.perf_counter() - t) * 1e3
        del model, module, predictor, emb, want
        torch.cuda.empty_cache()

        # (c) the ONNX encoder: ViT-B float32 (its first ONNX_ENCODER_DEPTH
        # blocks) through the numpy runtime.
        enc_model = seeded_model(ONNX_ENCODER, dev, ONNX_ENCODER_DEPTH)
        blob, seconds["(c) ONNX encoder export"] = timed(
            lambda: export_onnx.export_encoder_onnx(enc_model))
        export_onnx.runtime.check_model(_wire.parse("ModelProto", blob))
        rt = export_onnx.runtime.load(blob)
        del blob
        t = time.perf_counter()
        got = rt.run({"input": x.permute(0, 3, 1, 2).cpu().contiguous().numpy()})
        seconds["(c) numpy runtime"] = time.perf_counter() - t
        with torch.no_grad():
            want = sam_lib.encode_image(enc_model, x, "eager").permute(0, 3, 1, 2)
        err = rel(got["image_embeddings"], want)
        nbytes = len(_wire.serialize(rt.model))
        del rt, got, enc_model
        check(err <= ONNX_ENC_TOL and "2 GiB" in refused,
              f"export (c): ONNX {ONNX_ENCODER} encoder (first {ONNX_ENCODER_DEPTH} blocks, "
              f"{nbytes} bytes) numpy runtime vs the "
              f"card's eager encoder rel L2 {err:.3e} (<= {ONNX_ENC_TOL}); ViT-H: {refused}")
        print(f"  ONNX {ONNX_ENCODER} encoder: export {seconds['(c) ONNX encoder export']:.1f} s, "
              f"numpy runtime {seconds['(c) numpy runtime']:.1f} s (host); ViT-H refused in "
              f"{refuse_ms:.1f} ms  [{card}]")
        torch.cuda.empty_cache()

        # (a) first the float32 forward on the eager path; (f) the Profiler
        # around 10 bf16 ViT-H set_image calls, then (a) sam.forward on the
        # same bf16 encoder through the kernels.
        model = build()
        images = torch.from_numpy(r.integers(0, 256, (2, size, size, 3)).astype(np.float32))
        images, pts = images.to(dev), torch.tensor([[[0.2, 0.3], [0.7, 0.65]],
                                                    [[0.5, 0.5], [0.1, 0.9]]], device=dev) * size
        labs = torch.tensor([[1.0, 0.0], [1.0, 1.0]], device=dev)
        with torch.no_grad():
            reset_counts()
            plain, seconds["(a) float32 eager forward B=2"] = timed(
                lambda: sam_lib.forward(model, images, pts, labs, multimask_output=True,
                                        attn_impl="eager"))
            plain_counts = counts()
        model.image_encoder.to(torch.bfloat16)
        predictor = SamPredictor(model)
        wait, warmup, active = PROFILE_WINDOW
        t = time.perf_counter()
        with Profiler(str(work / "profile"), wait, warmup, active) as prof:
            for _ in range(wait + warmup + active):
                predictor.set_image(image)
                torch.cuda.synchronize()
                prof.step()
        seconds["(f) profiled set_image x10"] = time.perf_counter() - t
        with open(prof.trace_path) as f:
            kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        traced = {n: sum(n in k for k in kernels) for n in ("flash_windowed", "flash_global")}
        check(traced == {"flash_windowed": 28 * active, "flash_global": 4 * active},
              f"export (f): Profiler{PROFILE_WINDOW} trace of 10 set_image calls names the flash "
              f"kernels {traced} (28/4 x {active}); {pathlib.Path(prof.trace_path).name}, "
              f"{pathlib.Path(prof.trace_path).stat().st_size} bytes")
        del prof, predictor

        with torch.no_grad():
            reset_counts()
            (masks, iou, low), seconds["(a) forward B=2"] = timed(
                lambda: sam_lib.forward(model, images, pts, labs, multimask_output=True))
            launched = counts()
            errs = []
            for i in range(2):
                x1 = sam_lib.preprocess(model, images[i:i + 1]).to(torch.bfloat16)
                low1, iou1 = sam_lib.decode_masks(
                    model, sam_lib.encode_image(model, x1).float(),
                    points=(pts[i:i + 1], labs[i:i + 1]), multimask_output=True)
                errs += [rel(low[i], low1[0]), rel(iou[i], iou1[0]),
                         rel(masks[i], sam_lib.resize_bilinear(low1, (size, size))[0])]
        ok = (masks.shape == (2, 3, size, size) and iou.shape == (2, 3)
              and low.shape == (2, 3, 4 * h, 4 * w) and bool(torch.isfinite(masks).all()))
        vs_plain = max(rel(a, b) for a, b in zip((masks, iou, low), plain))
        check(ok and launched == flash_launches and plain_counts == zero
              and vs_plain <= BATCH_TOL and max(errs) <= FORWARD_SPLIT_TOL,
              f"export (a): sam.forward ViT-H bf16 B=2, 2 clicks each: launches "
              f"{ {n: c for n, c in launched.items() if c} } (28/4 a forward); rel L2 vs the "
              f"float32 eager forward (no launch) {vs_plain:.3e} (<= {BATCH_TOL}), vs per-image "
              f"encode + decode {max(errs):.3e} (<= {FORWARD_SPLIT_TOL})")
        del model, images, masks, low, plain
        torch.cuda.empty_cache()

        # (g) the CLI, as a user runs it.
        out = work / "cli_decoder.onnx"
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sam_quantization_tpu_torch.cli.export",
                               "vit_h", "--format", "onnx", "--output", str(out)],
                              cwd=repo, capture_output=True, text=True, timeout=600)
        seconds["(g) cli.export vit_h onnx"] = time.perf_counter() - t
        try:
            line = json.loads(proc.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            line = {}
        check(proc.returncode == 0 and line.get("format") == "onnx"
              and line.get("bytes") == out.stat().st_size and line.get("opset") == 11,
              f"export (g): cli.export vit_h --format onnx exit {proc.returncode}: {line}")
        if proc.returncode != 0:
            print(proc.stderr[-3000:])
    except BaseException:
        child.kill()
        child.wait()
        raise
    finally:
        runner_thread.join()
        shutil.rmtree(work, ignore_errors=True)
    print("  export seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"  [{card}]")
    print(f"export phase {time.perf_counter() - phase_t:.1f} s")

    def finish_aoti() -> None:
        """(e): wait for the compile, then the cached-int8 package against
        its eager encoder, from Python and by aoti_runner."""
        t = time.perf_counter()
        try:
            rc = child.wait(timeout=AOTI_WAIT_S)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
            rc = f"killed after {AOTI_WAIT_S} s more"
        waited = time.perf_counter() - t
        compiled = time.perf_counter() - aoti_t
        log = (aoti_dir / "compile.log").read_text()
        last = log.strip().splitlines()[-1][-300:] if log.strip() else "no output"
        try:
            check(rc == 0 and (aoti_dir / "aoti_enc" / "model.pt2").exists(),
                  f"export (e): AOTInductor package compiled by its own process (exit {rc}): "
                  f"{last}")
            if rc != 0:
                print(log[-3000:])
            check("path" in runner_box, "export (e): aoti_runner built with g++ "
                                        + runner_box.get("error", "")[-2000:])
            if rc != 0 or "path" not in runner_box:
                return
            qmodel, x, act = aoti_int8_model(dev)
            with torch.no_grad():
                want = sam_lib.encode_image(qmodel, x, "eager")
                got_py, from_py = timed(lambda: ex.load_aoti(str(aoti_dir / "aoti_enc"))(x))
            got_cc, by_runner = run_runner(aoti_dir / "aoti_enc", {"image": x}, "enc")
            py_err = rel(got_py, want)
            cc_err = rel(got_cc["image_embeddings"], want) if got_cc else float("inf")
            both = rel(got_cc["image_embeddings"], got_py) if got_cc else float("inf")
            check(py_err <= INT8_F32_TOL and cc_err <= INT8_F32_TOL,
                  f"export (e): cached-int8 {AOTI_ENCODER} AOTInductor encoder (sym W4 g128, "
                  f"{len(act)} static scales) vs its eager encoder rel L2 from Python "
                  f"{py_err:.3e}, by aoti_runner {cc_err:.3e} (<= {INT8_F32_TOL}; runner vs "
                  f"Python {both:.3e}); runner {runner_box['path'].name}")
            print(f"  export (e) seconds: started to finished {compiled:.2f} (waited after step "
                  f"21 {waited:.2f}), runner build {runner_box['seconds']:.2f}, from Python "
                  f"{from_py:.2f}, by the runner {by_runner:.2f}  [{card}]")
            del qmodel, want, got_py
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(aoti_dir, ignore_errors=True)

    return finish_aoti


# Tuned tiles of the weight-only packed-weight kernels (ops/autotune.py,
# csrc/quant_matmul.cu), at ViT-H's linear shapes, W4 (W3 at qkv)
# with groups of 128: (what, M, K, N, bits). M 4900 is the 25 windows of 196
# tokens, 4096 the global blocks and the MLP.
TILE_SHAPES = (("qkv", 4900, 1280, 3840, 4), ("proj", 4900, 1280, 1280, 4),
               ("global qkv", 4096, 1280, 3840, 4), ("global proj", 4096, 1280, 1280, 4),
               ("lin1", 4096, 1280, 5120, 4), ("lin2", 4096, 5120, 1280, 4),
               ("qkv", 4900, 1280, 3840, 3))
# Rel-pos resize (step 20): a ViT-H global attention (1280 wide, 16 heads,
# 127-row tables made for grid 64) at other grids: 48 and 32 shrink the
# tables to 95 and 63 rows, 80 and 128 grow them to 159 and 255. JAX's
# dispatch (ops/flash_attention.route) sends grids whose width divides 128
# to flash_global, the others to flash_rowblock.
REL_GRIDS = (48, 80, 32, 128)


def tile_table(shapes, bits: int, dtype, pack_block: int = 128) -> dict:
    """A tuned table whose entries name the candidate tiles other than the
    default, taken in turn over ``shapes`` ((M, K, N) with groups of 128), so
    that each of them serves at least one layer shape; the default tile
    where it is the only candidate (float32)."""
    from sam_quantization_tpu_torch.ops import autotune

    table = {}
    for i, (M, K, N) in enumerate(shapes):
        cands = autotune.candidate_blocks(M, N, K, 128, pack_block, dtype)
        others = cands[1:] or cands
        table[autotune._key(M, K, N, 128, bits, dtype)] = list(others[i % len(others)])
    return table


def tile_phase(dev, card: str, randn, rel_ok, cuda_ms, repo: pathlib.Path) -> dict:
    """Every candidate tile at TILE_SHAPES, float32 and bfloat16: held to the
    plain version by ``rel_ok``, bit-equal to the default tile's launch
    (every tile walks K in the same tiles, and float32 instantiates only its
    default, so no tile changes an output's sum order), and timed by CUDA
    events; then ``tune_model_shapes`` (ViT-H, M 4096, W4, bfloat16) into a
    temporary table, read back from its file. Returns {(name, dtype tag,
    tile): {"err", "ms"}} at the qkv shape."""
    import torch

    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.ops import autotune
    from sam_quantization_tpu_torch.ops import quant_matmul as qm

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        for what, M, K, N, bits in TILE_SHAPES:
            name = "quant_matmul3" if bits == 3 else "quant_matmul"
            p = packed_lib.quantize_rtn(randn(K, N, std=K**-0.5), bits, 128)
            x = randn(M, K, dtype=dtype)
            ref = qm.quant_matmul_plain(x, p)
            default = qm.quant_matmul(x, p)
            cands = autotune.candidate_blocks(M, N, K, 128, p.pack_block, dtype)
            check(cands[0] == qm.pick_blocks(M, N, K, 128, p.pack_block, bits, dtype)
                  and len(cands) == len(autotune.TILES[dtype]),
                  f"{name} W{bits} {what} {tag}: candidates {cands}, default {cands[0]}")
            times = []
            for tile in cands:
                out = qm.quant_matmul_tiled(x, p, tile)
                torch.cuda.synchronize()
                err, ok = rel_ok(out, ref, dtype)
                equal = torch.equal(out, default)
                check(ok and out.dtype == dtype and equal,
                      f"{name} W{bits} {what} {tag} tile {tile}: max|d| {err:.3e} vs plain, "
                      f"{'bit-equal to' if equal else 'not bit-equal to'} the default tile")
                ms = cuda_ms(lambda tile=tile: qm.quant_matmul_tiled(x, p, tile), 20)
                times.append(ms)
                if what == "qkv":
                    rows[(name, tag, tile)] = dict(err=err, ms=ms)
            print(f"{name} W{bits} {what} {tag} (M {M}, K {K}, N {N}) by tile: " + ", ".join(
                f"{bm}x{bn}x{bk} {ms:.4f} ms" for (bm, bn, bk), ms in zip(cands, times))
                + f"; fastest {cands[times.index(min(times))]}  [{card}]")
            del p, x, ref, default
    # The tuner, as tools/autotune.py runs it, into a temporary table.
    tmp = repo / "build" / "chip_autotune"
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / "table.json"
    path.unlink(missing_ok=True)
    try:
        autotune._table = None
        t = time.perf_counter()
        table = autotune.tune_model_shapes("vit_h", M=4096, bits=4, groupsize=128,
                                           dtype=torch.bfloat16, path=str(path), verbose=False)
        seconds = time.perf_counter() - t
        on_disk = json.loads(path.read_text())
    finally:
        autotune._table = {}
        shutil.rmtree(tmp, ignore_errors=True)
    C, H = 1280, 5120
    keys = {autotune._key(4096, K, N, 128, 4): (K, N) for K, N in ((C, 3 * C), (C, C), (C, H), (H, C))}
    check(on_disk == table and set(table) == set(keys) and all(
              tuple(v) in autotune.candidate_blocks(4096, keys[k][1], keys[k][0], 128, 128)
              for k, v in table.items()),
          f"tune_model_shapes vit_h M 4096 W4 bfloat16 in {seconds:.3f} s: {table}")
    return rows


def relpos_phase(dev, card: str, randn, reset_counts, counts, zero: dict, head_split_ok,
                 cuda_ms) -> None:
    """Step 20: a ViT-H global attention whose 127-row rel-pos tables are
    resized (get_rel_pos) for REL_GRIDS. At each grid: the card's get_rel_pos
    against the CPU's (float32, atol 1e-6: the resize's sums in another
    order); in float32 and bfloat16, the attention kernel JAX's dispatch
    picks on the resized tiles against its plain version at the head-split
    bound (plain run a head at a time at grid 128), and the module's kernel
    branch (one launch of that kernel, counts reset just before and read just
    after) against its eager branch (not at grid 128, whose eager logits
    would take 17 GB a copy) at the encode bounds (rel. L2 1e-3 float32,
    BF16_TOL bfloat16)."""
    import torch

    from sam_quantization_tpu_torch.models import configs
    from sam_quantization_tpu_torch.models import image_encoder as ie
    from sam_quantization_tpu_torch.ops import flash_attention as fa

    cfg = configs.VIT_H.image_encoder
    C, nh, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    grid0 = cfg.grid_size
    attn = ie.Attention(cfg, (grid0, grid0), gen=torch.Generator(device=dev).manual_seed(9),
                        device=dev)
    with torch.no_grad():
        attn.rel_pos_h.copy_(randn(*attn.rel_pos_h.shape, std=0.2))
        attn.rel_pos_w.copy_(randn(*attn.rel_pos_w.shape, std=0.2))
    state = {n: t.clone() for n, t in attn.state_dict().items()}  # float32
    scale = hd**-0.5
    for g in REL_GRIDS:
        L = g * g
        route = fa.route(L, (g, g))
        card_rel = ie.get_rel_pos(g, g, state["rel_pos_h"])
        cpu_rel = ie.get_rel_pos(g, g, state["rel_pos_h"].cpu())
        d_rel = float((card_rel.cpu() - cpu_rel).abs().max())
        check(tuple(card_rel.shape) == (g, g, hd) and d_rel <= 1e-6,
              f"get_rel_pos grid {g} (127 -> {2 * g - 1} rows), card vs CPU: max|d| "
              f"{d_rel:.2e} (<= 1e-6)")
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, BF16_TOL)):
            tag = str(dtype).split(".")[1]
            attn.to(dtype)
            attn.load_state_dict(state)  # the float32 weights, rounded to dtype
            x = randn(1, g, g, C, dtype=dtype)
            with torch.no_grad():
                qkv = attn.qkv(x.reshape(1, L, C)).reshape(1, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
                q, k, v = (t.contiguous() for t in qkv)
                rel_h, rel_w = ie.decomposed_rel_pos_tiles(
                    q.reshape(nh, L, hd), attn.rel_pos_h, attn.rel_pos_w, (g, g), (g, g))
                rel_h = rel_h.reshape(1, nh, L, g).contiguous()
                rel_w = rel_w.reshape(1, nh, L, g).contiguous()
                out = fa.flash_attention_relpos(q, k, v, rel_h, rel_w, scale)
                if g <= 80:
                    ref = fa.flash_attention_plain(q, k, v, rel_h, rel_w, scale)
                else:
                    ref = torch.cat([fa.flash_attention_plain(
                        q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1], rel_h[:, h:h + 1],
                        rel_w[:, h:h + 1], scale) for h in range(nh)], 1)
                err, reading, ok = head_split_ok(out, ref, dtype)
                ms = cuda_ms(lambda: fa.flash_attention_relpos(q, k, v, rel_h, rel_w, scale), 5)
                del qkv, q, k, v, rel_h, rel_w, ref, out
                reset_counts()
                y = attn(x, windowed=False, attn_impl="kernel")
                torch.cuda.synchronize()
                launched = counts()
                msg = ""
                if g <= 80:
                    y_eager = attn(x, windowed=False, attn_impl="eager")
                    rel_err = float((y.float() - y_eager.float()).norm() / y_eager.float().norm())
                    ok &= rel_err <= tol
                    msg = f"; module kernel vs eager rel L2 {rel_err:.3e} (<= {tol})"
                    del y_eager
            check(ok and launched == {**zero, route: 1} and tuple(y.shape) == (1, g, g, C)
                  and bool(torch.isfinite(y.float()).all()),
                  f"rel-pos grid {g} {tag}: {route} on tables resized to {2 * g - 1} rows, "
                  f"max|d| {err:.3e} vs plain (reading {reading:.3e}), {ms:.4f} ms{msg}; module "
                  f"launches {({n: c for n, c in launched.items() if c})}  [{card}]")
            del x, y
            torch.cuda.empty_cache()


# The W-A8 kernels' tiles (csrc/quant_matmul_a8.cu's main build, the
# tiles of ops/autotune.TILES_A8) at TILE_SHAPES' 4-bit rows, both kernels,
# bfloat16 out; their instantiations' names in SASS and ptxas's report:
# (bits, sym, fine, bm, bn, out type).
A8_TILE_SHAPES = tuple((what, M, K, N) for what, M, K, N, bits in TILE_SHAPES if bits == 4)
A8_PATTERN = r"qmm_a8_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d+)ELi(\d+)E(13__nv_bfloat16|f)E"
# W-A8 launches of one ViT-H encode by layer shape (M, K, N): the 28
# windowed blocks' qkv and proj on the 4900 padded window tokens, the 4
# global blocks' on 4096, every MLP on 4096.
A8_SHAPE_LAUNCHES = {(4900, 1280, 3840): 28, (4900, 1280, 1280): 28, (4096, 1280, 3840): 4,
                     (4096, 1280, 1280): 4, (4096, 1280, 5120): 32, (4096, 5120, 1280): 32}
# The hoisted-windowed arms (models/image_encoder._use_hoisted_windowed):
# their environment gates, partition-first first.
HOIST_ARMS = (("partition-first", {}), ("SAMQ_HOIST_PROJ=1", {"SAMQ_HOIST_PROJ": "1"}),
              ("SAMQ_HOIST_PROJ=1 SAMQ_HOIST_QKV=1",
               {"SAMQ_HOIST_PROJ": "1", "SAMQ_HOIST_QKV": "1"}))
HOIST_TOL = BF16_TOL  # the bf16 kernel path's bound against its eager path
HOIST_ITERS = 3  # profiled encodes an arm
STEP_SECONDS = {}  # seconds of each step, in order (mark)
_STEP_START = [time.perf_counter()]


def mark(step: str) -> None:
    """Print and keep the seconds since the last mark as step ``step``'s."""
    now = time.perf_counter()
    STEP_SECONDS[step] = now - _STEP_START[0]
    _STEP_START[0] = now
    print(f"step {step}: {STEP_SECONDS[step]:.1f} s")


def a8_tile_table(bits: int = 4) -> dict:
    """A tuned table (JAX's bare keys, groups of 128) naming 256 x 128 and
    256 x 64 in turn over A8_SHAPE_LAUNCHES' shapes."""
    from sam_quantization_tpu_torch.ops import autotune

    return {autotune._key(M, K, N, 128, bits): [*autotune.TILES_A8[1 + i % 2], 128]
            for i, (M, K, N) in enumerate(A8_SHAPE_LAUNCHES)}


def a8_tile_launches(table: dict, name: str, dtype) -> dict:
    """The W-A8 launches by tile that one ViT-H encode makes under ``table``."""
    from sam_quantization_tpu_torch.ops import autotune

    want = {}
    for (M, K, N), n in A8_SHAPE_LAUNCHES.items():
        tile = tuple(table.get(autotune._key(M, K, N, 128, 4), (*autotune.TILES_A8[0], 128)))
        want[(name, dtype, tile)] = want.get((name, dtype, tile), 0) + n
    return want


def a8_tile_phase(card: str, randn, cuda_ms, log) -> dict:
    """The W-A8 tiles: ptxas's spill bytes of every main-build
    instantiation (0 at every tile, bits, kernel and output type; read where
    this run built the library: ``log``), then every candidate tile of both
    kernels at A8_TILE_SHAPES in bfloat16, each bit-equal to the plain
    version and to the default tile's launch (every tile walks K in the same
    tiles and segments), timed by CUDA events, the fastest printed a shape.
    Returns {(name, tile): {"err", "ms"}} at the qkv shape."""
    import torch

    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.ops import autotune
    from sam_quantization_tpu_torch.ops import quant_matmul as qm

    if log is not None:
        usage = ptxas_usage(log, A8_PATTERN)
        main = {k: u for k, u in usage.items() if k[2] == "0"}
        want = {(b, s, "0", str(bm), str(bn), o) for b in "248" for s in "01"
                for bm, bn in autotune.TILES_A8 for o in ("f", "13__nv_bfloat16")}
        by_tile = {}
        for (b, s, _, bm, bn, o), u in sorted(main.items()):
            by_tile.setdefault(f"{bm}x{bn}", []).append(u)
        check(set(main) == want and all(u[0] == u[1] == 0 for u in main.values()),
              f"quant_matmul_a8 main build, ptxas over {len(main)} instantiations (36): " + "; ".join(
                  f"{t} spill bytes {max(u[0] + u[1] for u in us)}, registers "
                  f"{min(u[2] for u in us)}-{max(u[2] for u in us)}" for t, us in by_tile.items()))
        fine = {k: u for k, u in usage.items() if k[2] == "1" and (u[0] or u[1])}
        print("  quant_matmul_a8 FINE build (128 x 128, not tiled), ptxas spill stores / loads: "
              + (", ".join(f"W{k[0]} {'sym' if k[1] == '1' else 'asym'} {k[5][-8:]} "
                           f"{u[0]} / {u[1]} B" for k, u in sorted(fine.items())) or "none"))
    else:
        print("quant_matmul_a8 ptxas report not read (cached build)")
    rows = {}
    for sym in (True, False):
        name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
        for what, M, K, N in A8_TILE_SHAPES:
            std = K**-0.5
            p = packed_lib.with_act_bits(packed_lib.quantize_rtn(
                randn(K, N, std=std) + (0.0 if sym else 1.5 * std), 4, 128, sym), 8)
            xq, xs = qm.quantize_activations_int8(randn(M, K, dtype=torch.bfloat16))
            plain = qm.a8_matmul_plain(xq, xs, p, torch.bfloat16, sym)
            default = qm.a8_matmul(xq, xs, p, torch.bfloat16, sym)
            cands = autotune.candidate_blocks_a8(M, N, K, 128, p.pack_block)
            check(cands[0] == qm.pick_blocks_a8(M, N, K, 128, p.pack_block, 4)
                  and len(cands) == len(autotune.TILES_A8) and qm.a8_main_build(K, 128, 128, 4),
                  f"{name} {what}: candidates {cands}, default {cands[0]}")
            times = []
            for tile in cands:
                out = qm.a8_matmul_tiled(xq, xs, p, tile, torch.bfloat16, sym)
                torch.cuda.synchronize()
                err = float((out.float() - plain.float()).abs().max())
                to_plain, to_default = torch.equal(out, plain), torch.equal(out, default)
                check(to_plain and to_default and out.dtype == torch.bfloat16,
                      f"{name} W4 {what} bfloat16 tile {'x'.join(map(str, tile))}: "
                      f"{'bit-equal' if to_plain else f'max|d| {err:.3e}'} to plain, "
                      f"{'' if to_default else 'not '}bit-equal to the default tile")
                ms = cuda_ms(lambda tile=tile: qm.a8_matmul_tiled(xq, xs, p, tile,
                                                                  torch.bfloat16, sym), 20)
                times.append(ms)
                if what == "qkv":
                    rows[(name, tile)] = dict(err=err, ms=ms)
            print(f"{name} W4 {what} bfloat16 (M {M}, K {K}, N {N}) by tile: " + ", ".join(
                f"{bm}x{bn}x{bk} {ms:.4f} ms" for (bm, bn, bk), ms in zip(cands, times))
                + f"; fastest {'x'.join(map(str, cands[times.index(min(times))]))}  [{card}]")
            del p, xq, xs, plain, default
    return rows


def hoist_phase(dev, card: str, build, image, reset_counts, counts, want: dict) -> None:
    """Step 21: the hoisted-windowed path (models/image_encoder.py,
    ``SAMQ_HOIST_PROJ`` / ``SAMQ_HOIST_QKV``), ViT-H bf16 served in three
    modes (``want``: dense, W4, cached int8 and each one's launches a
    ``set_image``). Each mode runs HOIST_ARMS in turn, the gates set before
    that arm's first call: a warm-up ``set_image``, one with counts reset just
    before and read just after (the mode's launches: hoisting changes the
    token counts of qkv and proj, not the launches), its embedding against
    partition-first's (rel L2, HOIST_TOL; whether bit-equal), and the device
    time of the 28 windowed blocks under the profiler (each windowed block
    in a range; the mean of HOIST_ITERS encodes in one profile), with the
    whole encode's device busy time beside it."""
    import os

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.nn import packed as packed_lib
    from sam_quantization_tpu_torch.predictor import SamPredictor
    from sam_quantization_tpu_torch.quant import act_scales as act_lib
    from sam_quantization_tpu_torch.quant import sequential as seq

    phase_t = time.perf_counter()

    def stage_ms(enc, x):
        """(windowed blocks' device ms, the encode's device busy ms) a
        encode, and the windowed blocks profiled, over HOIST_ITERS encodes."""
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(HOIST_ITERS):
                h = enc.embed(x)
                for blk in enc.blocks:
                    if blk.window_size > 0:
                        with record_function("windowed block"):
                            h = blk(h, "kernel")
                    else:
                        h = blk(h, "kernel")
                enc.neck_forward(h)
            torch.cuda.synchronize()
        events = prof.key_averages()
        spans = [e for e in events if e.key == "windowed block" and e.device_type == DeviceType.CPU]
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA and e.key != "windowed block")
        return (sum(e.device_time_total for e in spans) / 1e3 / HOIST_ITERS,
                busy / 1e3 / HOIST_ITERS, sum(e.count for e in spans))

    for mode, launches in want.items():
        model = build()
        if mode == "cached int8":
            calib = copy.deepcopy(model.image_encoder).to(torch.bfloat16)
            xc = torch.from_numpy(np.random.default_rng(21).standard_normal((1, 1024, 1024, 3))
                                  .astype(np.float32)).to(dev, torch.bfloat16)
            act = act_lib.calibrate_act_scales(calib, [xc], margin=1.1)
            del calib, xc
        if mode != "dense":
            seq.rtn_quantize_encoder(model.image_encoder, seq.GPTQConfig(
                bits=4, groupsize=128, sym=mode == "cached int8"))
        if mode == "cached int8":
            packed_lib.cache_int8(model.image_encoder, act_scales=act,
                                  skip=packed_lib.default_serve_skip(1280))
        model.image_encoder.to(torch.bfloat16)
        predictor = SamPredictor(model)
        enc = model.image_encoder
        x = sam_lib.preprocess(model, torch.from_numpy(
            np.random.default_rng(22).integers(0, 256, (1, 1024, 1024, 3)).astype(np.float32))
            .to(dev)).to(torch.bfloat16)
        base, readings = None, []
        for arm, gates in HOIST_ARMS:
            for k in ("SAMQ_HOIST_PROJ", "SAMQ_HOIST_QKV"):
                os.environ.pop(k, None)
            os.environ.update(gates)
            try:
                predictor.set_image(image)
                reset_counts()
                predictor.set_image(image)
                torch.cuda.synchronize()
                got = counts()
                emb = predictor.features.float().clone()
                windowed, busy, blocks = stage_ms(enc, x)
            finally:
                for k in gates:
                    os.environ.pop(k, None)
            if base is None:
                base, rel_err, equal = emb, 0.0, True
            else:
                rel_err = float((emb - base).norm() / base.norm())
                equal = torch.equal(emb, base)
            check(got == launches and bool(torch.isfinite(emb).all()) and rel_err <= HOIST_TOL
                  and blocks == 28 * HOIST_ITERS,
                  f"hoist {mode} bf16 {arm}: {blocks} windowed blocks profiled (28 x "
                  f"{HOIST_ITERS}); launches a "
                  f"set_image "
                  f"{ {n: c for n, c in got.items() if c} }; embedding "
                  + ("bit-equal to" if equal else f"rel L2 {rel_err:.3e} (<= {HOIST_TOL}) from")
                  + " partition-first's")
            readings.append(f"{arm} {windowed:.3f} ms (encode busy {busy:.3f})")
        print(f"hoist {mode} bf16, windowed-stage device ms (28 blocks, mean of {HOIST_ITERS} "
              f"encodes): "
              + "; ".join(readings) + f"  [{card}]")
        del predictor, model, enc, x, base, emb
        torch.cuda.empty_cache()
    print(f"hoist phase {time.perf_counter() - phase_t:.1f} s")


# Step 22, the quality table (tools/quality_table.py) and its trainer
# (tools/train_synthetic.py). QUALITY_SCENES: the held-out scenes of
# vit_tiny_synth's table, at least 32, and the most that keep the step near
# 150 s: on an NVIDIA H100 80GB HBM3 machine (700 W) the step read 133.6 s at
# 32 scenes and 244.6 s at 48 (each scene runs 17 decodes a row).
QUALITY_SCENES = 32
# Launches an encode at vit_tiny (2 windowed blocks of 4 windows, 2 global
# blocks of 64 tokens, 16 block linears): the base rows on the eager branch
# (--attn-impl xla) launch only their packed kernels (the cached-int8 rows'
# int8 products, attn.proj left dense below ViT-H's width); the kernel-path
# rows (--attn-impl auto) add the attention kernels, and the _epi row routes
# attn.proj to int8: the windowed kernels' int8-out epilogue feeds it, and
# the global blocks' head-split kernel (no epilogue) a quantizing product.
QUALITY_LAUNCHES = {
    "fp32": {}, "gptq_int4": {"quant_matmul": 16}, "gptq_int3": {"quant_matmul3": 16},
    "rtn_int4": {"quant_matmul": 16}, "fq_int8": {}, "fq_int8_tuned": {},
    "a8_serving": {"int8_matmul": 12},
    "bf16_kernels": {"flash_windowed": 2, "flash_whole": 2},
    "a8_serving_kernels": {"flash_windowed": 2, "flash_whole": 2, "int8_matmul": 12},
    "a8_serving_kernels_epi": {"flash_windowed": 2, "flash_whole": 2,
                               "flash_windowed int8-out": 2, "int8_matmul": 14,
                               "int8_matmul_pre": 2},
}
QUALITY_KERNEL_ROWS = ("bf16_kernels", "a8_serving_kernels", "a8_serving_kernels_epi")
# Each row that launches a kernel is run again through the plain versions on
# the CPU from the same quantized weights: its 5-click loop with the card's
# own clicks replayed (the loop's clicks draw from one generator across the
# scenes, so a flipped pixel would move every later click), its per-click
# mIoU within QUALITY_PLAIN_IOU_TOL of the card's (the card test's bound),
# and each scene's embedding within QUALITY_EMB_TOL (rel. L2) of the card's:
# by the encoder's dtype, and for the cached-int8 rows by their int8
# rounding (an ulp before a linear can move an input across an int8
# rounding point, as A8_TINY_TOL's note says). Limits set from the first
# H100 run: float32 packed rows 5.3e-7 to 6.0e-7, so 1e-5; bf16_kernels
# 4.07e-3, so 2e-2; cached int8 6.53e-3 (float32) to 9.65e-3 (bf16, _epi),
# so 3e-2; per-click mIoU gaps 0 to 1.85e-4.
QUALITY_PLAIN_IOU_TOL = 1e-2
QUALITY_EMB_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 3e-2}
# train_synthetic --resume on a copy of vit_tiny_synth's latest (step 24000):
# QUALITY_TRAIN_STEPS steps (batch 8, lr 3e-4, 5 clicks) on the card, one
# flash_train forward a block a step (4 flash_whole launches), then its
# latest read by the quality tool (fp32, QUALITY_SCENES scenes): the click-5
# mIoU within QUALITY_TRAIN_TOL of QUALITY_TRAIN_CLICK5. The card draws its
# training clicks from a CUDA generator, so its weights differ from any CPU
# run's. The same 20 steps on the CPU at seeds 0, 1 and 2 (other pools,
# batches and clicks) read 0.9399, 0.9382 and 0.9450 (the checkpoint itself
# 0.9417): their mean, and 0.01, past twice the largest seed's gap (0.004).
QUALITY_TRAIN_STEPS = 20
QUALITY_TRAIN_CLICK5 = 0.9410
QUALITY_TRAIN_TOL = 1e-2
# The same resumed step once on the card and once on the CPU, both with the
# first error pixel in raster order as each click and TF32 off, held as
# tests/test_torch_train_synthetic.py holds the port's steps to JAX's: each
# leaf's update within 1e-3 of its largest plus two float32 steps of its
# largest weight; the key biases (zero exact gradient, float32 noise on both
# sides) within the largest move of one AdamW step at a carried state.
QUALITY_STEP_RTOL = 1e-3
QUALITY_ADAM_STEP = 3e-4 * (0.1 / 0.001**0.5 + 1e-4)  # --lr 3e-4, b1 0.9, b2 0.999
# The full-width leg: the same tool on a seeded ViT-H written by the port's
# save_checkpoint, fp32 on the eager branch, rtn_int4 and bf16_kernels on the
# kernel branch; launches an encode, exact.
QUALITY_VIT_H_LAUNCHES = {
    "fp32": {},
    "rtn_int4": {"quant_matmul": 64, "fused_mlp": 32, "flash_windowed": 28, "flash_global": 4},
    "bf16_kernels": {"flash_windowed": 28, "flash_global": 4},
}


@contextlib.contextmanager
def encode_launches(reset_counts, counts, log: list):
    """While inside, every click-loop backend's encode runs with the counts
    set to 0 just before it and read just after it: ``log`` gets one dict a
    backend (a configuration), whose ``"runs"`` hold one dict of non-zero
    counts an encode, beside the backend's ``"model"`` and ``"attn_impl"``,
    each encode's output on the CPU (``"embs"``) and each click loop's
    (samples, keywords, result) (``"loops"``)."""
    from sam_quantization_tpu_torch.evaluation import click_eval

    make, loop = click_eval.make_sam_backend, click_eval.click_loop_eval

    def backend(model, ctx=None, attn_impl="kernel"):
        encode, decode = make(model, ctx=ctx, attn_impl=attn_impl)
        entry = {"runs": [], "embs": [], "loops": [], "model": model, "attn_impl": attn_impl}
        log.append(entry)

        def counted(x):
            reset_counts()
            emb = encode(x)
            entry["runs"].append({k: v for k, v in counts().items() if v})
            entry["embs"].append(emb.float().cpu())
            return emb

        return counted, decode

    def looped(encode, decode, samples, **kw):
        res = loop(encode, decode, samples, **kw)
        log[-1]["loops"].append((samples, kw, res))
        return res

    click_eval.make_sam_backend, click_eval.click_loop_eval = backend, looped
    try:
        yield
    finally:
        click_eval.make_sam_backend, click_eval.click_loop_eval = make, loop


def plain_replay(entry: dict):
    """(the largest rel. L2 gap of a scene's embedding, the largest gap of a
    click's mIoU) between a card row's first click loop and the same loop
    through the plain versions on the CPU, from a CPU copy of the row's
    model, with the card's clicks replayed."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.evaluation import click_eval
    from sam_quantization_tpu_torch.models import sam as sam_lib

    cpu = copy.deepcopy(entry["model"]).to("cpu")
    encode_raw, decode = click_eval.make_sam_backend(cpu, attn_impl=entry["attn_impl"])
    embs = []

    def encode(x):
        emb = encode_raw(sam_lib.preprocess(cpu, torch.from_numpy(x)).numpy())
        embs.append(emb.float())
        return emb

    samples, kw, res = entry["loops"][0]
    plain = click_eval.click_loop_eval(encode, decode, samples, clicks_override=res.clicks, **kw)
    rel = max(float((c - e).norm() / e.norm()) for c, e in zip(entry["embs"], embs))
    gap = float(np.abs(np.asarray(res.mean_ious) - np.asarray(plain.mean_ious)).max())
    return rel, gap


def first_error_click(pred_logit, gt, gen):
    """The trainer's click rule with the first error pixel in raster order in
    place of a random one: the same clicks on the card and on the CPU."""
    import torch

    pred, gt_b = pred_logit > 0, gt > 0.5
    fn, fp = gt_b & ~pred, ~gt_b & pred
    use_fn = bool(fn.any())
    region = (fn if use_fn else fp).reshape(-1)
    if not bool(region.any()):
        region = torch.ones_like(region)
    idx = int(torch.argmax(region.int()))
    W = gt.shape[-1]
    return (torch.tensor([idx % W, idx // W], dtype=torch.float32, device=gt.device),
            torch.tensor(float(use_fn), device=gt.device))


def _quiet_main(main, argv):
    """(exit code, stdout) of a tool's ``main``; its lines but the rows'
    (printed again by the caller) echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    for line in buf.getvalue().splitlines():
        if not line.endswith("}") or line.startswith("{"):
            print(f"  | {line}", flush=True)
    return code, buf.getvalue()


def resumed_step_gap(work: pathlib.Path, synth: str, start: int, platforms=("gpu", "cpu")):
    """One ``train_synthetic --resume`` step from ``synth`` on each of
    ``platforms`` (the trainer's clicks by ``first_error_click``, TF32 off),
    then (exit codes, the worst leaf's update gap over its bound, the key
    biases' largest move, the leaves the first run moved, the leaves)."""
    import numpy as np

    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.models.configs import CONFIGS
    from sam_quantization_tpu_torch.quant.sequential import full_float32
    from sam_quantization_tpu_torch.tools import train_synthetic
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib
    from sam_quantization_tpu_torch.train import trainer as trainer_lib

    codes, dirs = [], []
    sample_click = trainer_lib._sample_error_click
    trainer_lib._sample_error_click = first_error_click
    try:
        with full_float32():
            for i, platform in enumerate(platforms):
                dirs.append(work / f"step_{i}_{platform}")
                shutil.copytree(synth, dirs[-1])
                codes.append(_quiet_main(train_synthetic.main, [
                    "--resume", "--out", str(dirs[-1]), "--steps", str(start + 1),
                    "--eval-samples", "2", "--platform", platform])[0])
    finally:
        trainer_lib._sample_error_click = sample_click

    def weights(directory):
        model = sam_lib.Sam(CONFIGS["vit_tiny"], device="cpu")
        ckpt_lib.load_weights(str(directory), model, "latest")
        return {n: p.detach().numpy() for n, p in model.named_parameters()}

    old, got, want = weights(synth), weights(dirs[0]), weights(dirs[1])
    worst, bias_move, moved = 0.0, 0.0, 0
    for n in old:
        upd, ref = got[n] - old[n], want[n] - old[n]
        moved += bool(np.any(upd))
        free = np.zeros(upd.shape, bool)  # the key biases' elements
        if n.endswith("k_proj.bias"):
            free[:] = True
        elif n.endswith("attn.qkv.bias"):
            free[upd.size // 3:2 * upd.size // 3] = True
        bias_move = max(bias_move, float(np.abs(upd[free]).max(initial=0.0)))
        tol = (QUALITY_STEP_RTOL * np.abs(ref).max(initial=0.0)
               + 2 * np.spacing(np.abs(old[n]).max(initial=0.0)))
        worst = max(worst, float(np.abs(upd[~free] - ref[~free]).max(initial=0.0)) / tol)
    return codes, worst, bias_move, moved, len(old)


def quality_phase(dev, card: str, reset_counts, counts, repo: pathlib.Path) -> None:
    """Step 22: the quantization-quality table and its trainer on the card.
    (a) ``tools.quality_table`` on ``checkpoints/vit_tiny_synth``, its default
    configurations on the eager branch, then the three kernel-path rows merged
    in on the kernel branch: both runs exit 0 with ``ci_ok`` (each kernel row
    inside its base row's CI95, JAX's own gate), every encode's launches
    exactly QUALITY_LAUNCHES; (b) ``tools.train_synthetic --resume`` for
    QUALITY_TRAIN_STEPS steps on a copy of it: finite losses, exact launches,
    AdamW's count on by as many steps and the weights moved, ``latest`` read
    back by the quality tool within QUALITY_TRAIN_TOL; then one resumed step
    on the card held to the same step on the CPU; (c) the ViT-H leg
    (QUALITY_VIT_H_LAUNCHES). Each row of (a) that launches a kernel is also
    run through the plain versions on the CPU (``plain_replay``)."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.tools import quality_table, train_synthetic
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib
    from sam_quantization_tpu_torch.train import trainer as trainer_lib

    work = repo / "build" / "chip_quality"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    synth = str(repo / "checkpoints" / "vit_tiny_synth")
    try:
        # (a) the table, base rows then kernel rows
        t0 = time.perf_counter()
        out = work / "quality.json"
        common = ["--ckpt", synth, "--eval-samples", str(QUALITY_SCENES), "--out", str(out)]
        log = []
        with encode_launches(reset_counts, counts, log):
            code_base, _ = _quiet_main(quality_table.main, common)
            base_s = time.perf_counter() - t0
            code_kernel, _ = _quiet_main(quality_table.main, common + [
                "--merge", "--attn-impl", "auto", "--configs", *QUALITY_KERNEL_ROWS])
        table = json.loads(out.read_text())
        names = quality_table.DEFAULT_CONFIGS + list(QUALITY_KERNEL_ROWS)
        check(code_base == 0 and code_kernel == 0 and table["ci_ok"] is True
              and list(table["rows"]) == names,
              f"quality table, vit_tiny_synth, {QUALITY_SCENES} scenes on the card: exit codes "
              f"{code_base} / {code_kernel}, ci_ok {table['ci_ok']}, rows {list(table['rows'])} "
              f"({base_s:.1f} s base rows, {time.perf_counter() - t0:.1f} s in all)  [{card}]")
        for name, row in table["rows"].items():
            print(f"  {name}: click1 {row['click1_miou']} {row['click1_ci95']}, click5 "
                  f"{row['click5_miou']} {row['click5_ci95']}, NoC@90 {row['noc@90']} "
                  f"{row['noc@90_ci95']}" + (f", within {row['vs_base_row']}'s CI95: "
                                            f"{row['within_base_ci95']}"
                                            if "within_base_ci95" in row else ""))
        check(len(log) == len(names), f"quality table: {len(log)} backends for {len(names)} rows")
        for name, entry in zip(names, log):
            want, runs = QUALITY_LAUNCHES[name], entry["runs"]
            check(len(runs) == 2 * QUALITY_SCENES and all(r == want for r in runs),
                  f"quality table {name}: launches an encode {runs[0] if runs else None} over "
                  f"{len(runs)} encodes, all equal: {all(r == runs[0] for r in runs)} "
                  f"(want {want})")
        # the rows that launch kernels, again through the plain versions
        t1 = time.perf_counter()
        for name, entry in zip(names, log):
            if not QUALITY_LAUNCHES[name]:
                continue
            dtype = str(entry["model"].image_encoder.patch_embed.proj.weight.dtype)[6:]
            tol = QUALITY_EMB_TOL["int8" if name.startswith("a8_serving") else dtype]
            rel, gap = plain_replay(entry)
            check(rel <= tol and gap <= QUALITY_PLAIN_IOU_TOL,
                  f"quality table {name} against its plain versions on the CPU ({dtype}, the "
                  f"same weights, the card's clicks replayed, {QUALITY_SCENES} scenes): "
                  f"embedding rel. L2 {rel:.3e} (<= {tol}), per-click mIoU |d| {gap:.2e} "
                  f"(<= {QUALITY_PLAIN_IOU_TOL})")
        print(f"  plain replays {time.perf_counter() - t1:.1f} s")
        del log

        # (b) the trainer, resumed on a copy of vit_tiny_synth
        t0 = time.perf_counter()
        run = work / "train"
        shutil.copytree(synth, run)
        start = json.loads((run / "sam_model_latest.json").read_text())["epoch"]
        losses = []
        make_step = trainer_lib.make_train_step

        def recorded(*a, **kw):
            step = make_step(*a, **kw)

            def wrapped(*sa, **skw):
                aux = step(*sa, **skw)
                losses.append(float(aux["loss"]))
                return aux
            return wrapped

        trainer_lib.make_train_step = recorded
        reset_counts()
        try:
            code, text = _quiet_main(train_synthetic.main, [
                "--resume", "--out", str(run), "--steps", str(start + QUALITY_TRAIN_STEPS),
                "--eval-every", str(QUALITY_TRAIN_STEPS)])
        finally:
            trainer_lib.make_train_step = make_step
        train_counts = {k: v for k, v in counts().items() if v}
        train_s = time.perf_counter() - t0
        status = json.loads(text.splitlines()[-1])
        meta = json.loads((run / "sam_model_latest.json").read_text())
        check(code == 0 and len(losses) == QUALITY_TRAIN_STEPS
              and all(math.isfinite(v) for v in losses)
              and meta["epoch"] == start + QUALITY_TRAIN_STEPS
              and train_counts == {"flash_whole": 4 * QUALITY_TRAIN_STEPS},
              f"train_synthetic --resume, {QUALITY_TRAIN_STEPS} steps from step {start} on the "
              f"card: losses {losses[0]:.4f} .. {losses[-1]:.4f}, all finite "
              f"{all(math.isfinite(v) for v in losses)}, status {status}, latest at step "
              f"{meta['epoch']} (click1 {meta['click1']:.4f}, click5 {meta['click5']:.4f}), "
              f"launches {train_counts} ({train_s:.1f} s)  [{card}]")
        with np.load(run / "sam_model_latest.npz") as new, \
                np.load(pathlib.Path(synth) / "sam_model_latest.npz") as old:
            counts_ab = int(old["o0"]), int(new["o0"])
            leaves = [k for k in old.files if k.startswith("m")]
            moved = sum(bool(np.any(new[k] != old[k])) for k in leaves)
        check(counts_ab[1] == counts_ab[0] + QUALITY_TRAIN_STEPS and moved > 0.8 * len(leaves),
              f"the {QUALITY_TRAIN_STEPS} steps trained: AdamW's count {counts_ab[0]} -> "
              f"{counts_ab[1]}, {moved} of {len(leaves)} weight leaves moved")
        code, _ = _quiet_main(quality_table.main, [
            "--ckpt", str(run), "--name", "latest", "--configs", "fp32", "--eval-samples",
            str(QUALITY_SCENES), "--out", str(work / "trained.json")])
        click5 = json.loads((work / "trained.json").read_text())["rows"]["fp32"]["click5_miou"]
        check(code == 0 and abs(click5 - QUALITY_TRAIN_CLICK5) <= QUALITY_TRAIN_TOL,
              f"the trained latest in the quality tool: fp32 click5 mIoU {click5} (CPU runs "
              f"{QUALITY_TRAIN_CLICK5} +- {QUALITY_TRAIN_TOL})")

        # one resumed step on the card against the same step on the CPU
        t0 = time.perf_counter()
        codes, worst, bias_move, moved, n = resumed_step_gap(work, synth, start)
        check(codes == [0, 0] and worst <= 1.0 and bias_move <= QUALITY_ADAM_STEP
              and moved > 0.8 * n,
              f"one resumed train_synthetic step, card against CPU (first-error clicks, TF32 "
              f"off): exit codes {codes}, {moved} of {n} leaves moved, the worst leaf's "
              f"update gap {worst:.3f} of its bound ({QUALITY_STEP_RTOL} of its largest update "
              f"+ 2 ulp), key biases moved <= {bias_move:.2e} (<= {QUALITY_ADAM_STEP:.2e}) "
              f"({time.perf_counter() - t0:.1f} s)")

        # (c) the full-width leg: a seeded ViT-H through the same tool
        t0 = time.perf_counter()
        model = seeded_model("vit_h", dev)
        opt = trainer_lib.make_optimizer(trainer_lib.TrainConfig(), model)
        ckpt_lib.save_checkpoint(str(work / "vit_h"), model, opt, 0, "best")
        del model, opt
        torch.cuda.empty_cache()
        save_s = time.perf_counter() - t0
        leg = ["--model", "vit_h", "--ckpt", str(work / "vit_h"), "--eval-samples", "2",
               "--calib-samples", "1", "--num-clicks", "2", "--noc-clicks", "2",
               "--out", str(work / "vit_h.json")]
        log = []
        with encode_launches(reset_counts, counts, log):
            codes = [_quiet_main(quality_table.main, leg + ["--configs", "fp32"])[0],
                     _quiet_main(quality_table.main, leg + [
                         "--merge", "--attn-impl", "auto", "--configs", "rtn_int4",
                         "bf16_kernels"])[0]]
        rows = json.loads((work / "vit_h.json").read_text())["rows"]
        ious = [v for r in rows.values() for k, v in r.items()
                if k.startswith("click") and k.endswith("_miou")]
        check(codes == [0, 0] and list(rows) == list(QUALITY_VIT_H_LAUNCHES)
              and all(0.0 <= v <= 1.0 for v in ious),
              f"quality table at ViT-H widths (seeded weights, 2 scenes, 2 clicks): exit codes "
              f"{codes}, rows {list(rows)}, mIoUs in [0, 1] (random weights: not read); "
              f"checkpoint written in {save_s:.1f} s, {time.perf_counter() - t0:.1f} s in all")
        for name, entry in zip(QUALITY_VIT_H_LAUNCHES, log):
            want, runs = QUALITY_VIT_H_LAUNCHES[name], entry["runs"]
            check(len(runs) == 4 and all(r == want for r in runs),
                  f"quality table ViT-H {name}: launches an encode {runs[0] if runs else None} "
                  f"over {len(runs)} encodes (want {want})")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# Step 23: the stage-anatomy probes on a CUDA-graph carried timer
# (tools/timing.timed_carry) and the FQ override search. Each probe runs
# STAGE_ITERS applications a stage; every stage's launches over the capture
# are exactly STAGE_ITERS times these per-application counts (block_anatomy
# by its block's tag; a stage or case not named launches none).
STAGE_ITERS = 16
_W4_ATTN = {"quant_matmul": 2}
BLOCK_STAGE_LAUNCHES = {
    "bf16": {"part+attn(flash)": {"flash_windowed": 1}, "full block": {"flash_windowed": 1}},
    "int4-w": {"part+qkv+mix": {"quant_matmul": 1}, "part+attn(eager)": _W4_ATTN,
               "part+attn(flash)": {**_W4_ATTN, "flash_windowed": 1},
               "ln2+mlp": {"fused_mlp": 1},
               "full block": {**_W4_ATTN, "flash_windowed": 1, "fused_mlp": 1},
               "full block (eager)": {"quant_matmul": 4}},
    "a8-static": {"part+qkv+mix": {"int8_matmul": 1}, "part+attn(eager)": {"int8_matmul": 1},
                  "part+attn(flash)": {"int8_matmul": 1, "flash_windowed": 1},
                  "ln2+mlp": {"int8_matmul": 2},
                  "full block": {"int8_matmul": 3, "flash_windowed": 1},
                  "full block (eager)": {"int8_matmul": 3}},
}
ATTN_CASE_LAUNCHES = {
    "qkv int8-static": {"int8_matmul": 1}, "proj int8-static": {"int8_matmul": 1},
    "proj int8-PRE": {"int8_matmul_pre": 1}, "lin1 int8-static": {"int8_matmul": 1},
    "FULL attn": {"int8_matmul": 1, "flash_windowed": 1, "flash_windowed int8-out": 1,
                  "int8_matmul_pre": 1},
}
FQ_TUNE_ARGS = ["--configs", "base", "diag8", "--eval-samples", "4", "--calib-samples", "2",
                "--noc-clicks", "4"]
# fq_tune card vs CPU: given the same qparams, click mIoU within float32
# rounding of the quant-mode forward (tests/test_torch_fq_tune.py's 1e-3);
# free running, each device's own calibration, the FQ tests' 1e-2
STEP23_IOU_TOL, STEP23_FREE_TOL = 1e-3, 1e-2


def stage_probe_phase(card: str, repo: pathlib.Path) -> None:
    """Step 23: ``tools.block_anatomy --model vit_h --int4 --a8``,
    ``attn_stage_probe``, ``mlp_serving_probe`` and ``rel_probe`` (ViT-H,
    STAGE_ITERS applications a stage), each stage one CUDA graph replay
    beside the eager loop: every time finite and above zero, the graph's
    carry bit-equal to the eager loop's, the launches over the capture exact
    and none over the replays; then :func:`fq_tune_card_vs_cpu`."""

    import torch

    from sam_quantization_tpu_torch.tools import (attn_stage_probe, block_anatomy, fq_tune,
                                                  mlp_serving_probe, rel_probe)

    it = ["--iters", str(STAGE_ITERS)]

    def held(what, t, floor=None, per=None):
        """Check one Carried; per-application launches ``per``."""
        want = {k: STAGE_ITERS * n for k, n in (per or {}).items()}
        times = [t.ms, t.eager_ms] + ([t.ms - floor.ms, t.eager_ms - floor.eager_ms]
                                      if floor else [])
        ok = (all(math.isfinite(v) for v in times) and t.ms > 0 and t.eager_ms > 0
              and torch.equal(t.carry, t.eager_carry) and t.launches == want
              and not t.replay_launches)
        if not ok:
            check(False, f"step 23 {what}: graph {t.ms} eager {t.eager_ms} ms, carries "
                         f"equal {torch.equal(t.carry, t.eager_carry)}, launches {t.launches} "
                         f"(want {want}), over replays {t.replay_launches}")
        return ok

    t0 = time.perf_counter()
    anatomy = block_anatomy.measure(["--model", "vit_h", "--int4", "--a8"] + it)
    n_ok = n = 0
    for tag, rows in anatomy.items():
        floor = rows[0][1]
        for name, t in rows:
            n += 1
            n_ok += held(f"block_anatomy {tag} {name}", t, None if name == "noop" else floor,
                         BLOCK_STAGE_LAUNCHES[tag].get(name))
    check([name for name, _ in anatomy["bf16"]] == [
        "noop", "ln", "partition", "part+qkv+mix", "part+attn(eager)", "part+attn(flash)",
        "ln2+mlp", "full block", "full block (eager)"], "step 23 block_anatomy stage list")
    full = dict(anatomy["a8-static"])["full block"]
    print(f"  block_anatomy: {time.perf_counter() - t0:.1f} s; a8-static full block graph: "
          f"capture + instantiate {full.capture_s:.3f} s, peak {full.graph_bytes / 2**20:.1f} "
          f"MiB  [{card}]")

    t1 = time.perf_counter()
    for name, t, floor in attn_stage_probe.measure(it):
        n += 1
        per = next((v for k, v in ATTN_CASE_LAUNCHES.items() if name.startswith(k)), None)
        n_ok += held(f"attn_stage_probe {name}", t, floor, per)
    mlp = mlp_serving_probe.measure(it)
    for name, t in mlp.items():
        n += 1
        n_ok += held(f"mlp_serving_probe {name}", t, None if name == "floor" else mlp["floor"])
    floor, rows = rel_probe.measure(it)
    for name, t in [("floor", floor)] + rows:
        n += 1
        n_ok += held(f"rel_probe {name}", t, None if name == "floor" else floor)
    print(f"  attn_stage_probe, mlp_serving_probe, rel_probe: {time.perf_counter() - t1:.1f} s")
    check(n_ok == n, f"step 23: {n_ok}/{n} stages finite, above zero, graph carry bit-equal "
                     f"to the eager loop's, launches exact over the capture and none over "
                     f"the replays")

    fq_tune_card_vs_cpu(card, repo)


def fq_tune_card_vs_cpu(card: str, repo: pathlib.Path) -> None:
    """Step 23's ``fq_tune --configs base diag8`` (FQ_TUNE_ARGS) on the CPU,
    then on the card given the CPU's qparams call for call (base, diag8's
    first and second calibration): rows within STEP23_IOU_TOL click mIoU and
    NoC equal, the worst-8 lists equal. Then free running on the card: its
    calibration differs from the CPU's by float32 sum order (step 16), so
    its rows are held within STEP23_FREE_TOL, and the points whose
    calibration differs are printed as the cause of any other difference."""
    import torch

    from sam_quantization_tpu_torch.quant.fq import pipeline as fqp
    from sam_quantization_tpu_torch.tools import fq_tune

    argv = ["--ckpt", str(repo / "checkpoints" / "vit_tiny_synth")] + FQ_TUNE_ARGS
    calibrate = fqp.calibrate_sam

    def run(platform, replace=None):
        calibs = []

        def recorded(*a, **k):
            q = replace() if replace else calibrate(*a, **k)
            calibs.append(q)
            return q
        fqp.calibrate_sam = recorded
        t = time.perf_counter()
        try:
            code, text = _quiet_main(fq_tune.main, argv + ["--platform", platform])
        finally:
            fqp.calibrate_sam = calibrate
        lines = text.splitlines()
        worst = next(ln for ln in lines if "worst-8" in ln).split(":", 1)[1].strip()
        print(f"  fq_tune {platform}{' (given the CPU qparams)' if replace else ''}: "
              f"{lines[-1]} ({time.perf_counter() - t:.1f} s)")
        return code, json.loads(lines[-1]), worst, calibs

    cpu = run("cpu")
    given = iter(cpu[3])
    held = run("gpu", lambda: fqp.qparams_to(next(given), "cuda"))
    free = run("gpu")

    def rows_match(got, tol):
        return all(abs(got[c][k] - cpu[1][c][k]) <= tol and
                   (tol == STEP23_FREE_TOL or got[c][n] == cpu[1][c][n])
                   for c in cpu[1] for k in ("click1", "click5") for n in ("noc@85", "noc@90"))

    check(held[0] == cpu[0] == 0 and held[1].keys() == cpu[1].keys()
          and rows_match(held[1], STEP23_IOU_TOL) and held[2] == cpu[2],
          f"step 23 fq_tune: the card given the CPU's qparams, rows within "
          f"{STEP23_IOU_TOL} click mIoU and NoC equal, worst-8 list equal  [{card}]")
    # the cause of a free-running difference: the calibrations' own gaps
    gaps = []
    for k, (sc, z) in cpu[3][0].items():
        fsc, fz = (t.cpu() for t in free[3][0][k])
        rel = float(((fsc - sc).abs() / sc).max())
        flips = (int((torch.round(fsc / fsc.min()) != torch.round(sc / sc.min())).sum())
                 if sc.ndim else 0)
        if rel or flips or not torch.equal(fz, z):
            gaps.append((rel, k, flips, bool(torch.equal(fz, z))))
    gaps.sort(reverse=True)
    print(f"  fq_tune free-running card calibration against the CPU's (base): {len(gaps)} of "
          f"{len(cpu[3][0])} points differ; largest: " + "; ".join(
              f"{k} scale rel {r:.2e}, PTF flips {f}, zeros equal {z}" for r, k, f, z in gaps[:4]))
    same = free[1] == cpu[1] and free[2] == cpu[2]
    check(free[0] == 0 and free[1].keys() == cpu[1].keys() and rows_match(free[1], STEP23_FREE_TOL),
          f"step 23 fq_tune free running on the card: rows within {STEP23_FREE_TOL} of the "
          f"CPU's ({'equal' if same else 'they differ: the calibration gaps above'})")


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
    from sam_quantization_tpu_torch.ops import _build, autotune
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

    # No tuned table from the checkout: every phase launches the default
    # tiles, and only the tile phase and the tuned-table runs install one
    # (and put {} back).
    autotune._table = {}
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
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'}); by "
          f"library: " + ", ".join(f"{n} {t:.1f} s" for n, t in _build.BUILD_SECONDS.items()))
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {name}: {line.strip()}")
    mark("1-2 set-up and build")

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
    # body (qmm_tc_kernel<BITS, EPI, TBM, TBN>) holds HGMMA, bits 2, 3, 4, 8
    # in quant_matmul (plain epilogue) at every tile of autotune.TILES, bits
    # 2, 4, 8 in fused_mlp (both epilogues) at the default tile; and 0 bytes
    # of spill stores and loads in ptxas's report of each instantiation but
    # the default tile's, which (256 x 128, 512 threads, 128 registers a
    # thread) spills at 3 and 8 bits as it did before it took a tile:
    # printed (read where this run built the library).
    tc_pattern = r"qmm_tc_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"
    default_tc = tuple(map(str, autotune.TILES[torch.bfloat16][0]))
    for name, want in (("quant_matmul", {(b, "0", str(m), str(n)) for b in "2348"
                                         for m, n in autotune.TILES[torch.bfloat16]}),
                       ("fused_mlp", {(b, e, *default_tc) for b in "248" for e in "01"})):
        tc_counts = tensor_core_counts(_build.library_path(name), _build._nvcc(), tc_pattern)
        usage = ptxas_usage(logs[name], tc_pattern) if name in logs else {}
        spilled = {k: u for k, u in usage.items() if u[0] or u[1]}
        check(set(tc_counts) == want and all(c[0] > 0 for c in tc_counts.values())
              and (name not in logs or (set(usage) == want
                                        and all(k[2:] == default_tc for k in spilled))),
              f"{name} bf16 instantiations, HGMMA in SASS: " + ", ".join(
                  f"W{b} epilogue {e} {m}x{n} {c[0]}"
                  for (b, e, m, n), c in sorted(tc_counts.items()))
              + "; ptxas " + (("spill stores / loads: " + ", ".join(
                  f"W{k[0]} epilogue {k[1]} {k[2]}x{k[3]} {u[0]} / {u[1]} B"
                  for k, u in sorted(spilled.items()))
                  if spilled else "0 spill bytes") if name in logs
                  else "log not read (cached build)"))
    # The float32 packed-weight body (qmm_f32_kernel<BITS, EPI, WIDE> of
    # qmm_f32.cuh), bits 2, 3, 4, 8 in quant_matmul and 2, 4, 8 with both
    # epilogues in fused_mlp, each with both word loaders (WIDE: tiles of
    # one 128-row pack block): FFMA and no HGMMA or HMMA (tensor cores would
    # mean TF32), and 0 bytes of spill stores and loads in ptxas's report of
    # each instantiation (read where this run built the library).
    f32_pattern = r"qmm_f32_kernelILi(\d+)ELi(\d+)ELb(\d)E"
    for name, want in (("quant_matmul", {(b, "0", w) for b in "2348" for w in "01"}),
                       ("fused_mlp", {(b, e, w) for b in "248" for e in "01" for w in "01"})):
        mix = tensor_core_counts(_build.library_path(name), _build._nvcc(), f32_pattern)
        usage = ptxas_usage(logs[name], f32_pattern) if name in logs else {}
        check(set(mix) == want and all(c[4] > 0 and c[0] == c[1] == 0 for c in mix.values())
              and (name not in logs or (set(usage) == want and all(
                  u[0] == u[1] == 0 for u in usage.values()))),
              f"{name} float32 instantiations, FFMA / HGMMA+HMMA in SASS, ptxas spill "
              f"stores / loads bytes, registers: " + ", ".join(
                  f"W{b} epilogue {e}{' wide' if w == '1' else ''} {c[4]} / {c[0] + c[1]}, "
                  + ("{} / {} B, {} regs".format(*usage[b, e, w]) if (b, e, w) in usage
                     else "ptxas log not read (cached build)")
                  for (b, e, w), c in sorted(mix.items())))
    # The W-A8 kernels (bits 2, 4, 8; sym and asym; float32 and bf16 out):
    # the 36 main-build instantiations (at each tile of autotune.TILES_A8)
    # run int8 wgmma (IGMMA), the 12 FINE ones (one 128 x 128 tile) int8
    # mma.sync (IMMA). Their ptxas spill bytes are read in a8_tile_phase.
    tc_counts = tensor_core_counts(_build.library_path("quant_matmul_a8"), _build._nvcc(),
                                   A8_PATTERN)
    for fine, ins, i in (("0", "IGMMA", 3), ("1", "IMMA", 2)):
        tiles = autotune.TILES_A8 if fine == "0" else ((128, 128),)
        want = {(b, s, str(bm), str(bn), o) for b in "248" for s in "01" for bm, bn in tiles
                for o in ("f", "13__nv_bfloat16")}
        build = {(b, s, bm, bn, o): c for (b, s, f, bm, bn, o), c in tc_counts.items()
                 if f == fine}
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
    # (flash_f32.cuh, as flash_attn_f32_kernel<HDP, REL>, 16); the probes'
    # libraries hold no other kernel.
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
        check(not others, f"{name}: no kernel but probe_tc_kernel and flash_f32.cuh's body "
                          f"(flash_attn_f32_kernel) ({others})")
        if name != "flash_attn":
            check(not cuda_core, f"{name}: no float32 head-split kernel")
    # Every float32 attention build runs flash_f32.cuh's register-tiled
    # body: flash_attn_f32_kernel<HDP, REL> (flash_whole, flash_rowblock),
    # flash_windowed_f32_kernel<HDP, OutT> and flash_global_f32_kernel<HDP,
    # BIAS, OutT> (BIAS 1 the rel rows in shared memory; BIAS 2 rel_w in
    # registers, built only for the tiles where they fit, flash_f32.cuh's
    # regs_bias_fits), hd tiles 16..128, float and int8 out: FFMA and no
    # HGMMA or HMMA in each (tensor cores would mean TF32), and 0 bytes of
    # spill stores and loads in ptxas's report (read where this run built
    # the library).
    for name, pattern, want in (
            ("flash_attn", r"flash_attn_f32_kernelILi(\d+)ELb(\d)E",
             {(h, r) for h in hdps for r in "01"}),
            ("flash_windowed", r"flash_windowed_f32_kernelILi(\d+)E(f|a)E",
             {(h, o) for h in hdps for o in "fa"}),
            ("flash_global", r"flash_global_f32_kernelILi(\d+)ELi(\d)E(f|a)E",
             {(h, b, o) for h in hdps for b in "12" for o in "fa"
              if b == "1" or h not in ("32", "64", "96")})):
        mix = tensor_core_counts(_build.library_path(name), _build._nvcc(), pattern)
        usage = ptxas_usage(logs[name], pattern) if name in logs else {}
        spills = sorted({u[0] + u[1] for u in usage.values()})
        regs = sorted({u[2] for u in usage.values()})
        check(set(mix) == want and all(c[4] > 0 and c[0] == c[1] == 0 for c in mix.values())
              and (name not in logs or (set(usage) == want and spills == [0])),
              f"{name} float32 body ({len(mix)} instantiations): FFMA "
              f"{min((c[4] for c in mix.values()), default=0)}-"
              f"{max((c[4] for c in mix.values()), default=0)}, HGMMA+HMMA "
              f"{max((c[0] + c[1] for c in mix.values()), default=0)}, ptxas spill bytes "
              + (f"{spills}, registers {regs[0]}-{regs[-1]}" if regs
                 else "not read (cached build)"))

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
            r["ms"] = cuda_ms(kernel, 20)
            r["plain_ms"] = cuda_ms(lambda: plain(x), 10)
            r["library_ms"] = cuda_ms(library, 20)
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

    # bfloat16 fused_mlp at M 129, N 2560 with pack blocks 12 (W8, K 768, H
    # 3072) and 80 (W2, K 1280, H 5120): both sides round h to bf16 between
    # the products, so a one-step flip of h (the first product's float32 sum
    # order) can move an output past rel_ok. Read the kernel's h against the
    # plain version's: the elements that differ and by how many bf16 steps,
    # and those that differ by more than one step and more than 2^-22 of the
    # pre-activation sum's scale S = |x| @ |W1| + |b1| (none: past one step
    # only near zero, where a bf16 step is finer than float32 resolves the
    # sum); the output against the plain second product fed the kernel's
    # own h, at rel_ok.
    def bf16_ordinal(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    def fused_mlp_with_hidden(x, p1, p2):
        """(out, h): the kernel's C function with an (M, H) scratch read here
        (a comparison launch, not counted)."""
        (M_, K_), H_, N_ = x.shape, p1.out_features, p2.out_features
        out = torch.empty((M_, N_), dtype=x.dtype, device=dev)
        hidden = torch.empty((M_, H_), dtype=x.dtype, device=dev)
        _build.launch(
            "fused_mlp", _build.DTYPE_CODE[x.dtype], p1.bits, x.data_ptr(),
            p1.qweight.data_ptr(), p1.scales.data_ptr(), p1.zeros.data_ptr(),
            p1.bias.data_ptr(), p2.qweight.data_ptr(), p2.scales.data_ptr(),
            p2.zeros.data_ptr(), out.data_ptr(), hidden.data_ptr(), M_, K_, H_, N_,
            p1.groupsize, p1.pack_block, p2.groupsize, p2.pack_block,
            torch.cuda.current_stream().cuda_stream)
        return out, hidden

    gen.manual_seed(8)
    for bits, g_, K_, H_ in ((8, 12, 768, 3072), (2, 80, 1280, 5120)):
        Mh, Nh = 129, 2560
        x = randn(Mh, K_, dtype=torch.bfloat16)
        l1 = packed_lib.quantize_rtn(randn(K_, H_, std=0.05), bits, g_, bias=randn(H_, std=0.01))
        l2 = packed_lib.quantize_rtn(randn(H_, Nh, std=0.05), bits, g_)
        out, hk = fused_mlp_with_hidden(x, l1, l2)
        w1 = packed_lib.dequantize(l1).to(torch.bfloat16).float()
        hp = fm.gelu_tanh(torch.matmul(x.float(), w1) + l1.bias).to(torch.bfloat16)
        steps = (bf16_ordinal(hk) - bf16_ordinal(hp)).abs()
        S = torch.matmul(x.float().abs(), w1.abs()) + l1.bias.abs()
        dh = (hk.float() - hp.float()).abs()
        far = int(((steps > 1) & (dh > 2.0**-22 * S)).sum())
        dh_multi = float(dh[steps > 1].max()) if bool((steps > 1).any()) else 0.0
        ref = torch.matmul(hk.float(), packed_lib.dequantize(l2).to(torch.bfloat16).float()).to(
            torch.bfloat16)
        err, ok = rel_ok(out, ref, torch.bfloat16)
        err_plain, ok_plain = rel_ok(out, fm.fused_mlp_plain(x, l1, l2), torch.bfloat16)
        check(ok and far == 0 and {l1.pack_block, l2.pack_block} == {g_},
              f"fused_mlp bfloat16 W{bits} pack block {g_} (M {Mh}, K {K_}, H {H_}, N {Nh}): h "
              f"differs from the plain h in {int((steps > 0).sum())} of {steps.numel()} "
              f"elements, {int((steps > 1).sum())} by more than one bf16 step (at most "
              f"{int(steps.max())}; max |d| there {dh_multi:.3e}, "
              f"{far} past 2^-22 S); out vs the plain second "
              f"product of the kernel's h max|d| {err:.3e}; vs the plain version max|d| "
              f"{err_plain:.3e} ({'within' if ok_plain else 'past'} rel_ok)")
        del x, l1, l2, w1, hk, hp, out, ref, S, dh

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

    # ------------------------------------------------------------ tuned tiles
    tile_rows_report = tile_phase(dev, card, randn, rel_ok, cuda_ms,
                                  pathlib.Path(__file__).resolve().parent)
    torch.cuda.empty_cache()
    a8_tile_rows = a8_tile_phase(card, randn, cuda_ms, logs.get("quant_matmul_a8"))
    torch.cuda.empty_cache()

    # Every float32 build beside its library call and bound (the JSON line
    # carries the bfloat16 rows, and flash_whole's float32 one).
    for (name, tag), r in report.items():
        if tag == "float32":
            print(f"float32 {name}: kernel {r['ms']:.4f} ms, library {r['library_ms']:.4f} ms "
                  f"(x lib {r['ms'] / r['library_ms']:.2f}), bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms  [{card}]")

    mark("3 kernels and tiles")

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
        mark("4 dense")

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
            if dtype == torch.float32:  # the float32 rows' launches in the kernels line
                f32_launches = {k: counts()[k] for k in ("flash_windowed", "flash_global",
                                                         "quant_matmul", "fused_mlp")}
            rel_err = float((e - ref).norm() / ref.norm())
            check(tuple(e.shape) == (1, 64, 64, 256) and bool(torch.isfinite(e).all())
                  and rel_err <= tol, f"W4 encode {tag} vs dequantized dense float32 eager: "
                                      f"rel L2 {rel_err:.3e} (<= {tol})")
        predictor, launches = serve_all("W4", w4_launches)
        print_device_profile("W4 set_image", lambda: predictor.set_image(images[0]))

        # Tuned tiles on the main path (ops/autotune.py's table, read by
        # pick_blocks at each launch): run() with no table, then with counts
        # reset just before and read just after, under a table naming the
        # other candidate tiles (tile_table). The launches are the default
        # run's, every launch takes a tile of the table and every tile of it
        # is launched, and the output is bit-equal to the default run's
        # (every tile keeps each sum's K order) or within ``tol``.
        tile_launches = {}

        def tiled_run(what, table, run, want, tol):
            autotune._table = {}
            base = run()
            autotune._table = table
            try:
                reset_counts()
                out = run()
                torch.cuda.synchronize()
                got, tiles = counts(), dict(qm.TILE_LAUNCHES)
            finally:
                autotune._table = {}
            equal = torch.equal(out, base)
            rel_err = float((out.float() - base.float()).norm() / base.float().norm())
            named = {tuple(v) for v in table.values()}
            check(got == want and {t for _, _, t in tiles} == named
                  and sum(tiles.values()) == want["quant_matmul"] + want["quant_matmul3"]
                  and (equal or rel_err <= tol),
                  f"{what} under a table of {len(table)} entries: launches "
                  f"{ {n: c for n, c in got.items() if c} }, by tile "
                  f"{ {'x'.join(map(str, t)): c for (_, _, t), c in tiles.items()} }; "
                  + ("bit-equal to" if equal else f"rel L2 {rel_err:.3e} (<= {tol}) from")
                  + " the default tiles' output")
            tile_launches.update(tiles)

        w4_shapes = [(Mw, C, 3 * C), (Mw, C, C), (Mg, C, 3 * C), (Mg, C, C)]
        tiled_run("W4 served set_image bfloat16", tile_table(w4_shapes, 4, torch.bfloat16),
                  lambda: predictor.set_image(images[0]), w4_launches, BF16_TOL)
        del predictor
        model.image_encoder.to(torch.float32)
        tiled_run("W4 encode float32", tile_table(w4_shapes, 4, torch.float32),
                  lambda: sam_lib.encode_image(model, x, "kernel"), w4_launches, 1e-3)
        torch.cuda.empty_cache()
        mark("5 W4")

        # W3: split-plane 3-bit never fuses, so all four linears of a block
        # run quant_matmul3 (float32 held as the W4 float32 encode, the
        # flash kernels against eager).
        model.image_encoder = dense_encoder
        seq.rtn_quantize_encoder(model.image_encoder, seq.GPTQConfig(bits=3, groupsize=128))
        ref = packed_lib.dense_copy(model.image_encoder)(x, "eager").float()
        for dtype, tol in ((torch.float32, W4_F32_TOL), (torch.bfloat16, BF16_TOL)):
            tag = str(dtype).split(".")[1]
            model.image_encoder.to(dtype)
            reset_counts()
            e = sam_lib.encode_image(model, x.to(dtype), "kernel").float()
            torch.cuda.synchronize()
            w3_launches = counts()
            check(w3_launches == {**flash_launches, "quant_matmul3": 128},
                  f"W3 encode {tag}: launches {w3_launches}")
            rel_err = float((e - ref).norm() / ref.norm())
            check(bool(torch.isfinite(e).all()) and rel_err <= tol,
                  f"W3 encode {tag} vs dequantized dense float32 eager: rel L2 {rel_err:.3e} "
                  f"(<= {tol})")
            if dtype == torch.float32:
                f32_launches["quant_matmul3"] = w3_launches["quant_matmul3"]
        launches["quant_matmul3"] = w3_launches["quant_matmul3"]
        # Tuned tiles at all four linears: qkv and proj of both token counts,
        # the MLP of the 4096 tokens.
        w3_shapes = w4_shapes + [(Mg, C, H), (Mg, H, C)]
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, BF16_TOL)):
            model.image_encoder.to(dtype)
            tiled_run(f"W3 encode {str(dtype).split('.')[1]}", tile_table(w3_shapes, 3, dtype),
                      lambda: sam_lib.encode_image(model, x.to(dtype), "kernel"),
                      {**flash_launches, "quant_matmul3": 128}, tol)
        del model, dense_encoder, ref, e
        torch.cuda.empty_cache()
        mark("6 W3")

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

        # The W-A8 kernels under a tuned table (JAX's bare keys, read by
        # pick_blocks_a8 at each launch) naming 256 x 128 and 256 x 64 in
        # turn over ViT-H's six linear shapes: counts reset just before the
        # run and read just after; the launches by tile are exactly what the
        # table names for each shape's layers (A8_SHAPE_LAUNCHES), the
        # launches by kernel the default run's, and the output bit-equal to
        # the default tile's (every tile keeps each output's sum).
        a8_table = a8_tile_table()

        def a8_tiled_run(what, name, run, want):
            autotune._table = {}
            base = run().clone()
            autotune._table = a8_table
            try:
                reset_counts()
                out = run()
                torch.cuda.synchronize()
                got, tiles = counts(), dict(qm.TILE_LAUNCHES)
            finally:
                autotune._table = {}
            named = a8_tile_launches(a8_table, name, torch.bfloat16)
            equal = torch.equal(out, base)
            check(got == want and tiles == named and equal,
                  f"{what} under a table naming 256x128 and 256x64 ({len(a8_table)} entries): "
                  f"launches {got[name]} {name}, by tile "
                  f"{ {'x'.join(map(str, t)): c for (_, _, t), c in sorted(tiles.items())} } "
                  f"(want { {'x'.join(map(str, t)): c for (_, _, t), c in sorted(named.items())} }); "
                  f"embedding {'' if equal else 'not '}bit-equal to the default tile's")
            tile_launches.update(tiles)

        a8_tiled_run("W4A8 served set_image bfloat16", "quant_matmul_a8_sym",
                     lambda: predictor.set_image(images[0]), a8_launches)
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
        with torch.no_grad():
            a8_tiled_run("W4A8 asymmetric encode bfloat16", "quant_matmul_a8",
                         lambda: encoder(x.to(torch.bfloat16), "kernel"), asym_launches)
        del encoder, dense_encoder, ref, e
        torch.cuda.empty_cache()
        mark("7 W4A8")

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
        mark("8 small inputs")

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
        mark("9 rel-less")

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
        mark("10 cached int8")

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
        mark("11 stage probes")

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
        mark("12 click loops")

        amg_server_phase(dev, card, vit_h, images, flash_launches, w4_launches, reset_counts,
                         counts, zero, repo)
        mark("13 AMG and server")

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

    mark("14 training")

    # --------------------------------------------------------------------- GPTQ
    gptq_solver_phase(dev, card)
    gptq_encoder_phase(dev, card, "vit_h", vit_h, images[0], w4_launches, reset_counts, counts,
                       repo / "build" / "chip_gptq")
    mark("15 GPTQ")

    # ------------------------------------------------------------------- FQ-ViT
    fq_phase(dev, card, "vit_h", vit_h, FQ_QPARAMS_VIT_H, reset_counts, counts, zero,
             repo / "build" / "chip_fq")
    mark("16 FQ-ViT")

    # ----------------------------------------------------------------- parallel
    parallel_phase(dev, card, vit_h, reset_counts, counts, flash_launches, train_launches,
                   {"W4": w4_launches, "W4A8": a8_launches, "cached int8": int8_launches})
    mark("17 parallel")

    # ------------------------------------------------------ classifiers, BRS
    classifier_brs_phase(dev, card, vit_h, reset_counts, counts, zero, flash_launches)
    mark("18 classifiers and BRS")

    # ------------------------------------------------------------------ export
    finish_export = export_phase(dev, card, vit_h, reset_counts, counts, zero, flash_launches)
    mark("19 export")

    # --------------------------------------------------------- rel-pos resize
    relpos_phase(dev, card, randn, reset_counts, counts, zero, head_split_ok, cuda_ms)
    mark("20 rel-pos resize")

    # ------------------------------------------------------ hoisted windowed
    hoist_phase(dev, card, vit_h, images[0], reset_counts, counts,
                {"dense": flash_launches, "W4": w4_launches, "cached int8": int8_launches})
    mark("21 hoisted windowed")

    # ---------------------------------------------------------- quality table
    quality_phase(dev, card, reset_counts, counts, repo)
    mark("22 quality table and trainer")

    # --------------------------------------------- stage probes and fq_tune
    stage_probe_phase(card, repo)
    mark("23 stage probes and fq_tune")
    finish_export()
    mark("19 (e) AOTInductor package (compiled beside 19-23)")
    print("step seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in STEP_SECONDS.items())
          + f"; total {sum(STEP_SECONDS.values()):.1f} s  [{card}]")

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
    # One row per kernel in its JSON_DTYPE build, then the float32 builds of
    # the serving attention and packed-weight kernels (their launches from
    # the float32 W4 encode).
    rows = [(name, JSON_DTYPE.get(name, "bfloat16"), launches[name]) for name in sources]
    rows += [(name, "float32", n) for name, n in f32_launches.items()]
    kernels = []
    for name, dtype, n in rows:
        src, replaces = sources[name]
        r = report[(name, dtype)]
        kernels.append({
            "name": name, "dtype": dtype, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": n, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    # The tuned tiles of quant_matmul and quant_matmul3 other than the
    # default: timed at the qkv shape (tile_phase), beside the default
    # row's plain version, bound and library call (the same function at the
    # same shape); launches from the runs under tile_table.
    for (name, tag, tile), r in tile_rows_report.items():
        dtype = torch.float32 if tag == "float32" else torch.bfloat16
        if tile == autotune.default_tile(128, dtype):
            continue
        base = report[(name, tag)]
        kernels.append({
            "name": f"{name} tile {'x'.join(map(str, tile))}", "dtype": tag, "route": "cuda",
            "source": csrc + "quant_matmul.cu", "replaces": sources[name][1],
            "launches": tile_launches.get((name, dtype, tile), 0), "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": base["plain_ms"], "bound_ms": base["bound_ms"],
            "bound_by": base["bound_by"], "library_ms": base["library_ms"],
        })
    # The W-A8 kernels' tiles other than the default, likewise (a8_tile_phase
    # at the qkv shape; launches from the W4A8 runs under a8_tile_table).
    for (name, tile), r in a8_tile_rows.items():
        if tile[:2] == autotune.TILES_A8[0]:
            continue
        base = report[(name, "bfloat16")]
        kernels.append({
            "name": f"{name} tile {'x'.join(map(str, tile))}", "dtype": "bfloat16",
            "route": "cuda", "source": csrc + "quant_matmul_a8.cu", "replaces": sources[name][1],
            "launches": tile_launches.get((name, torch.bfloat16, tile), 0),
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": base["plain_ms"],
            "bound_ms": base["bound_ms"], "bound_by": base["bound_by"],
            "library_ms": base["library_ms"],
        })
    if any(k["launches"] == 0 for k in kernels):
        print("chip_smoke: a kernel of the path was not launched: " + ", ".join(
            f"{k['name']} {k['dtype']}" for k in kernels if k["launches"] == 0), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--aoti-package"]:
        sys.exit(aoti_package(sys.argv[2]))
    sys.exit(main())
