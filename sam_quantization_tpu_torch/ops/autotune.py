"""On-card tile tuning for the weight-only packed-weight kernels.

Counterpart of ``sam_quantization_tpu/ops/autotune.py``: it times every
candidate tile of ``quant_matmul`` / ``quant_matmul3`` for one layer shape on
the card and persists the fastest to a JSON table that
``ops.quant_matmul.pick_blocks`` reads before each launch. The names, the
keys and the table's format are JAX's; what differs is what a tile is.

A tile is ``(bm, bn, bk)``: ``bm x bn`` outputs a block, ``bk`` K rows a
tile. The Pallas kernels take any tiling that fits the TPU's VMEM; the CUDA
bodies are templates instantiated at a fixed list of tiles
(:data:`TILES`, the same list as ``csrc/quant_matmul.cu``'s switch), each
held to Hopper's budgets:

* shared memory at most 227 KB a block (``MAX_SMEM``; :func:`smem_bytes`);
* registers: ``__launch_bounds__`` with no spill in ptxas's report (65536
  registers an SM, at most 255 a thread);
* bfloat16 (``csrc/qmm_tc.cuh``): a warpgroup owns 64 rows and issues
  ``wgmma.m64n{bn}k16``, n being 64 or 128;
* float32 (``csrc/qmm_f32.cuh``): 256 threads, each owning ``bm / 16 x
  bn / 16`` outputs.

Only tiles that were the fastest at some measured layer shape are
instantiated (PERF.md): at ViT-H's six linear shapes the bfloat16 256 x 64
tile beat the default at the global proj and lin2; no other tile, and no
float32 tile but the default, won anywhere. The bodies take more tiles;
one is added where a measured shape shows it winning.

``bk`` is always ``tile_rows(pack_block)``: K tiles are whole pack blocks
and the scales are indexed by ``k // groupsize`` inside the kernel, so the
group size does not set the K tile as it does in JAX.

Keys are JAX's ``f"{M}x{K}x{N}g{groupsize}b{bits}"`` for bfloat16, which is
what JAX tunes (its ``tune_shape`` draws a bfloat16 x); float32 entries add
the suffix ``f32``. The port's table is ``.samq_autotune_torch.json`` at
the repository root, never JAX's ``.samq_autotune.json``, and no table is
committed: without one every launch takes the default tile.

The W-A8 kernels (``quant_matmul_a8_sym``, ``quant_matmul_a8``) read the
same table, as JAX's ``_quant_matmul_a8_sym`` / ``_asym`` call
``pick_blocks``: one entry, tuned on the weight-only kernel, sets the tiles
of all three. Their main build (``csrc/quant_matmul_a8.cu``, int8 ``wgmma``,
one producer and two consumer warpgroups) is instantiated at
:data:`TILES_A8`: the default 128 x 128, and 256 x 128 and 256 x 64, every
tile the bfloat16 weight-only table can name, so a tuned entry launches in
both kernels. A 256-row tile decodes the weights half as often; its
consumers run two m64 chains a segment, and at 256 x 128 the producer gives
registers to them (``setmaxnreg``). A stage holds the x tile, the weight
tile with 16 rows of ones, the raw words and the scales (:func:`smem_bytes_a8`),
as many stages as fit, at most four. A W-A8 launch looks up JAX's bare key
whatever its output dtype: the int8 product does not depend on it, and
JAX's key has no dtype. Layouts the main build does not take (groups that
end inside a 32-deep k step, pack blocks that do not divide 128, ...: the
FINE build) run FINE's one 128 x 128 tile and ignore the table. The tuner
times the weight-only kernel only, as JAX's does.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional, Tuple

import torch

_TABLE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".samq_autotune_torch.json",
)
_table: Optional[Dict[str, list]] = None

# The instantiated (bm, bn) tiles of each body, the default first
# (csrc/quant_matmul.cu's switch).
TILES: Dict[torch.dtype, Tuple[Tuple[int, int], ...]] = {
    torch.bfloat16: ((256, 128), (256, 64)),
    torch.float32: ((128, 128),),
}
# The W-A8 kernels' main-build (bm, bn) tiles, the default first
# (csrc/quant_matmul_a8.cu's SAMQ_A8 list).
TILES_A8: Tuple[Tuple[int, int], ...] = ((128, 128), (256, 128), (256, 64))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}  # the tuner's --dtype
MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90
# The packed kernels against their plain version (here and in
# tests/test_torch_kernels_gpu.py): |d| <= rtol |ref| + mtol max|ref|; both
# multiply the same values and differ in the float32 sum order (bfloat16:
# two output steps).
QTOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (8e-3, 1e-3)}


def _key(M: int, K: int, N: int, groupsize: int, bits: int,
         dtype: torch.dtype = torch.bfloat16) -> str:
    key = f"{M}x{K}x{N}g{groupsize}b{bits}"
    return key if dtype == torch.bfloat16 else key + "f32"


def load_table(path: str = _TABLE_PATH) -> Dict[str, list]:
    """The table, read once: later calls return the first one read,
    whatever ``path`` they give (JAX's caching)."""
    global _table
    if _table is None:
        try:
            with open(path) as f:
                _table = json.load(f)
        except (OSError, ValueError):
            _table = {}
    return _table


def lookup(M: int, K: int, N: int, groupsize: int, bits: int,
           dtype: torch.dtype = torch.bfloat16):
    """Tuned (bm, bn, bk) or None."""
    hit = load_table().get(_key(M, K, N, groupsize, bits, dtype))
    return tuple(hit) if hit else None


def default_tile(pack_block: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The tile ``samq_quant_matmul`` launches."""
    from sam_quantization_tpu_torch.ops.quant_matmul import tile_rows

    return (*TILES[dtype][0], tile_rows(pack_block))


def smem_bytes(bm: int, bn: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block at tile (bm, bn), as the bodies'
    ``Tile<TBM, TBN>::SMEM`` sizes it (their static_assert holds it to
    :data:`MAX_SMEM`): two stages of the x and decoded W tiles and two
    mbarriers (bfloat16), or two x stages of rows padded to 132 floats and
    one W tile (float32)."""
    from sam_quantization_tpu_torch.ops.quant_matmul import MAX_TILE_K as kt

    if dtype == torch.bfloat16:
        return 2 * (bm * kt * 2 + kt * bn * 2) + 16
    return (2 * bm * (kt + 4) + kt * bn) * 4


def smem_bytes_a8(bm: int, bn: int, bits: int, sym: bool) -> Tuple[int, int]:
    """(stages, dynamic shared memory) of a W-A8 main-build block at tile
    (bm, bn), as ``a8tc::Layout<BITS, SYM, BM, BN>`` sizes them: a stage
    holds the x tile (bm x 128 int8), the weight tile with its 16 rows of
    ones ((bn + 16) x 128 u8), the tile's raw words (128 / (32 / bits) word
    rows of bn int32) and the scales (and zeros) of its four k steps; as many
    stages as fit beside a 16-byte mbarrier pair each and 1 KB of alignment,
    at most four."""
    from sam_quantization_tpu_torch.ops.quant_matmul import MAX_TILE_K as kt

    stage = bm * kt + (bn + 16) * kt + kt // (32 // bits) * bn * 4 + (kt // 32) * bn * 4 * (
        1 if sym else 2)
    stages = min(4, (MAX_SMEM - 1024) // (stage + 16))
    return stages, stages * (stage + 16) + 1024


def candidate_blocks(M: int, N: int, K: int, groupsize: int, pack_block: int,
                     dtype: torch.dtype = torch.bfloat16) -> List[Tuple[int, int, int]]:
    """The instantiated tiles that fit this shape: the default, and every
    other whose ``bn`` divides N (no column tile half masked) and whose
    ``bm`` is at most ``max(M, 128)`` (JAX's rule). Each holds the budgets
    of this module's docstring; ``groupsize`` and K do not restrict them
    (the K tile is ``tile_rows(pack_block)`` and a short last one is
    masked)."""
    from sam_quantization_tpu_torch.ops.quant_matmul import tile_rows

    bk = tile_rows(pack_block)
    default, *others = TILES[dtype]
    return [(*default, bk)] + [(bm, bn, bk) for bm, bn in others
                               if N % bn == 0 and bm <= max(M, 128)]


def candidate_blocks_a8(M: int, N: int, K: int, groupsize: int,
                        pack_block: int) -> List[Tuple[int, int, int]]:
    """The W-A8 main build's tiles that fit this shape, by
    :func:`candidate_blocks`' rules: the default, and every other whose
    ``bn`` divides N and whose ``bm`` is at most ``max(M, 128)``."""
    from sam_quantization_tpu_torch.ops.quant_matmul import tile_rows

    bk = tile_rows(pack_block)
    default, *others = TILES_A8
    return [(*default, bk)] + [(bm, bn, bk) for bm, bn in others
                               if N % bn == 0 and bm <= max(M, 128)]


def _cuda_only(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"autotune: tiles are timed on a CUDA card, not on {device}")
    return device


def tune_shape(M: int, K: int, N: int, bits: int = 4, groupsize: int = 128,
               dtype: torch.dtype = torch.bfloat16, iters: int = 10, verbose: bool = False,
               device="cuda") -> Tuple[Tuple[int, int, int], float]:
    """Time every candidate tile for one layer shape; returns (best, ms).

    RTN weights and x are drawn from seed 0 on the card. Each candidate's
    output is first held against ``quant_matmul_plain`` at :data:`QTOL`
    (``RuntimeError`` if it fails; a launch error raises from the launch),
    which is also its warm-up; then ``iters`` calls are timed by CUDA events
    and their median taken."""
    from sam_quantization_tpu_torch.nn import packed
    from sam_quantization_tpu_torch.ops import quant_matmul as qm

    device = _cuda_only(device)
    gen = torch.Generator(device=device).manual_seed(0)
    w = torch.randn((K, N), generator=gen, device=device) * 0.05
    p = packed.quantize_rtn(w, bits, groupsize)
    x = torch.randn((M, K), generator=gen, device=device).to(dtype)
    ref = qm.quant_matmul_plain(x, p).float()
    rtol, mtol = QTOL[dtype]
    bound = rtol * ref.abs() + mtol * ref.abs().max()
    best, best_ms = None, float("inf")
    for tile in candidate_blocks(M, N, K, p.groupsize, p.pack_block, dtype):
        err = (qm.quant_matmul_tiled(x, p, tile).float() - ref).abs()
        if not bool((err <= bound).all()):
            raise RuntimeError(f"autotune: tile {tile} at {_key(M, K, N, groupsize, bits, dtype)}"
                               f" is off its plain version by {float(err.max()):.3e}")
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            start.record()
            qm.quant_matmul_tiled(x, p, tile)
            end.record()
        torch.cuda.synchronize(device)
        ms = statistics.median(start.elapsed_time(end) for start, end in events)
        if verbose:
            print(f"  {tile}: {ms:.4f} ms")
        if ms < best_ms:
            best, best_ms = tile, ms
    return best, best_ms


def tune_model_shapes(model: str = "vit_h", M: int = 4096, bits: int = 4, groupsize: int = 128,
                      dtype: torch.dtype = torch.bfloat16, path: str = _TABLE_PATH,
                      verbose: bool = True, device="cuda") -> Dict[str, list]:
    """Tune the four encoder linear shapes of a model config and persist."""
    from sam_quantization_tpu_torch.models.configs import CONFIGS

    ecfg = CONFIGS[model].image_encoder
    C, H = ecfg.embed_dim, ecfg.mlp_dim
    table = dict(load_table(path))
    for K, N in [(C, 3 * C), (C, C), (C, H), (H, C)]:
        best, ms = tune_shape(M, K, N, bits, groupsize, dtype, verbose=verbose, device=device)
        table[_key(M, K, N, groupsize, bits, dtype)] = list(best)
        if verbose:
            print(f"{model} {K}x{N}: best {best} @ {ms:.3f} ms")
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    global _table
    _table = table
    return table
