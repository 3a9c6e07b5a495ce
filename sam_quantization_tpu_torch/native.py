"""The port's native host ops: a ctypes binding of ``csrc/host_runtime.cpp``.

Counterpart of ``sam_quantization_tpu/native``: COCO uncompressed RLE
encode/decode (single, batched and bit-packed), greedy box NMS and the exact
Euclidean distance transform that the click-loop evaluation's ``Clicker``
places its clicks with, and the block-planar packing of integer weight
grids. These run on the host around the card's work.

The library is built with ``g++`` at first use into
``build/libsamq_host_runtime-<hash>.so`` under the repository root, where
``<hash>`` covers the source, so an edited source builds anew. Where there
is no ``g++``, every entry point falls back to numpy (scipy for the
distance transform), with the same results; the C++ transform returns
float32, scipy's float64. :func:`pack_block_planar` returns None instead,
as JAX's does, and its caller packs with ``nn.packed``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "host_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
RLE_CAP = 8192  # counts per mask in the batched encoders' first pass
RLE_RETRY_BYTES = 1 << 28  # count buffer of one batched pass over masks past RLE_CAP

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsamq_host_runtime-{digest[:12]}.so"


def _build(path: Path) -> bool:
    """Compile into a temporary file and rename it into place, so processes
    that build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[samq_torch.native] build failed, using numpy fallbacks: {e}", file=sys.stderr)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None where it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.rle_encode.restype = i64
        lib.rle_encode.argtypes = [u8p, i64, i64, i64p, i64]
        for fn in (lib.rle_encode_batch, lib.rle_encode_batch_packed):
            fn.restype = i64
            fn.argtypes = [u8p, i64, i64, i64, i64p, i64, i64p, i64]
        lib.rle_decode.restype = None
        lib.rle_decode.argtypes = [i64p, i64, i64, i64, u8p]
        lib.rle_area.restype = i64
        lib.rle_area.argtypes = [i64p, i64]
        lib.box_nms.restype = i64
        lib.box_nms.argtypes = [f32p, f32p, i64, ctypes.c_float, i64p]
        lib.distance_transform_edt.restype = None
        lib.distance_transform_edt.argtypes = [u8p, i64, i64, f32p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.pack_block_planar.restype = None
        lib.pack_block_planar.argtypes = [i32p, i64, i64, ctypes.c_int, ctypes.c_int, i32p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ------------------------------------------------------------ numpy versions
def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """(H, W) binary -> COCO uncompressed counts (column-major runs, the
    first the count of 0s)."""
    flat = np.asarray(mask, bool).T.reshape(-1)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    counts = np.diff(np.concatenate([[0], change, [len(flat)]])).tolist()
    return [0] + counts if flat[0] else counts


def rle_counts_to_mask(counts, h: int, w: int) -> np.ndarray:
    mask = np.empty(h * w, dtype=bool)
    idx, parity = 0, False
    for count in counts:
        mask[idx: idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).T


def box_nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy IoU NMS -> kept indices, score-descending."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


# -------------------------------------------------------------- entry points
def rle_encode(mask: np.ndarray) -> List[int]:
    """(H, W) binary -> COCO uncompressed counts (column-major runs)."""
    lib = get_lib()
    h, w = mask.shape
    m = np.ascontiguousarray(mask, np.uint8)
    if lib is None:
        return mask_to_rle_counts(m)
    cap = h * w + 2
    out = np.empty(cap, np.int64)
    n = lib.rle_encode(_ptr(m, ctypes.c_uint8), h, w, _ptr(out, ctypes.c_int64), cap)
    if n <= 0:
        raise RuntimeError(f"rle_encode returned {n}")
    return out[:n].tolist()


def _encode_batch(fn, data: np.ndarray, h: int, w: int) -> List[List[int]]:
    """The counts of each of the masks in ``data`` from the batched encoder
    ``fn``, on threads: first at ``RLE_CAP`` counts a mask, then the masks
    that had more, again in batches, at the h*w + 1 counts a mask can have."""
    n = len(data)

    def run(part, cap):
        out = np.empty((len(part), cap), np.int64)
        lens = np.empty(len(part), np.int64)
        rc = fn(_ptr(part, ctypes.c_uint8), len(part), h, w, _ptr(out, ctypes.c_int64), cap,
                _ptr(lens, ctypes.c_int64), 0)
        if rc not in (0, -1):
            raise RuntimeError(f"{fn.__name__} returned {rc}")
        return out, lens

    out, lens = run(data, RLE_CAP)
    counts = [out[i, : lens[i]].tolist() if lens[i] >= 0 else None for i in range(n)]
    over = np.nonzero(lens < 0)[0]
    cap = h * w + 1
    step = max(1, RLE_RETRY_BYTES // (8 * cap))
    for j in range(0, len(over), step):
        idx = over[j: j + step]
        out, lens = run(np.ascontiguousarray(data[idx]), cap)
        for k, i in enumerate(idx):
            counts[i] = out[k, : lens[k]].tolist()
    return counts


def rle_encode_batch(masks: np.ndarray) -> List[List[int]]:
    """(N, H, W) binary -> the counts of each mask, encoded on threads."""
    masks = np.ascontiguousarray(masks, np.uint8)
    if masks.ndim != 3:
        raise ValueError(f"expected (N, H, W) masks, got {masks.shape}")
    n, h, w = masks.shape
    lib = get_lib()
    if lib is None or n == 0:
        return [rle_encode(m) for m in masks]
    return _encode_batch(lib.rle_encode_batch, masks, h, w)


def _unpack_columns(packed: np.ndarray, h: int) -> np.ndarray:
    """(..., W, ceil(H/8)) little-endian column bits -> (..., H, W) uint8."""
    return np.swapaxes(np.unpackbits(packed, axis=-1, bitorder="little", count=h), -1, -2)


def rle_encode_batch_packed(packed: np.ndarray, h: int, w: int) -> List[List[int]]:
    """Batched RLE of masks bit-packed column by column: ``packed`` is
    (N, W, ceil(H/8)) uint8, bit j of byte b the mask's row b*8+j; the runs
    are scanned off the packed bytes without unpacking."""
    packed = np.ascontiguousarray(packed, np.uint8)
    if packed.ndim != 3 or packed.shape[1] != w or packed.shape[2] != (h + 7) // 8:
        raise ValueError(f"expected (N, {w}, {(h + 7) // 8}) packed masks, got {packed.shape}")
    n = packed.shape[0]
    if n == 0:
        return []
    lib = get_lib()
    if lib is None:
        return rle_encode_batch(_unpack_columns(packed, h))
    return _encode_batch(lib.rle_encode_batch_packed, packed, h, w)


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """COCO uncompressed counts -> (H, W) bool."""
    lib = get_lib()
    if lib is None:
        return rle_counts_to_mask(counts, h, w)
    c = np.ascontiguousarray(counts, np.int64)
    if (c < 0).any():
        raise ValueError("negative RLE count")
    out = np.empty((h, w), np.uint8)
    lib.rle_decode(_ptr(c, ctypes.c_int64), len(c), h, w, _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def rle_area(counts) -> int:
    """Pixels set in an uncompressed RLE."""
    lib = get_lib()
    if lib is None:
        return int(sum(counts[1::2]))
    c = np.ascontiguousarray(counts, np.int64)
    return int(lib.rle_area(_ptr(c, ctypes.c_int64), len(c)))


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS of (N, 4) xyxy boxes -> kept indices, score-descending."""
    lib = get_lib()
    if lib is None:
        return box_nms_numpy(boxes, scores, iou_threshold)
    b = np.ascontiguousarray(boxes, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    if b.shape != (len(s), 4):
        raise ValueError(f"boxes {b.shape} for {len(s)} scores")
    keep = np.empty(len(b), np.int64)
    n = lib.box_nms(_ptr(b, ctypes.c_float), _ptr(s, ctypes.c_float), len(b),
                    ctypes.c_float(iou_threshold), _ptr(keep, ctypes.c_int64))
    return keep[:n]


def distance_transform_edt(mask: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance of each nonzero pixel to the nearest zero:
    float32 from the library, float64 from scipy where there is none."""
    m = np.ascontiguousarray(mask, np.uint8)
    lib = get_lib()
    if lib is None:
        from scipy import ndimage

        return ndimage.distance_transform_edt(m)
    h, w = m.shape
    out = np.empty((h, w), np.float32)
    lib.distance_transform_edt(_ptr(m, ctypes.c_uint8), h, w, _ptr(out, ctypes.c_float))
    return out


def pack_block_planar(w_int: np.ndarray, bits: int, pack_block: int) -> Optional[np.ndarray]:
    """Integer grid values (K, N) in [0, 2**bits), bits 2, 4 or 8 -> the
    block-planar int32 words (K // (32 // bits), N) that ``nn.packed``
    writes (``pack_int_weights``), or None where the library is absent
    (JAX's signature and fallback)."""
    lib = get_lib()
    K, N = w_int.shape
    per = 32 // bits
    wi = np.ascontiguousarray(w_int, np.int32)
    if lib is None:
        return None
    out = np.zeros((K // per, N), np.int32)
    lib.pack_block_planar(_ptr(wi, ctypes.c_int32), K, N, bits, pack_block,
                          _ptr(out, ctypes.c_int32))
    return out
