"""Build and load the port's CUDA kernels (``nvcc`` + ``ctypes``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own, at first use, into ``build/torch_kernels/lib<name>-<hash>.so`` under
the repository root, where ``<hash>`` covers the sources and the flags: an
edited source builds anew, an unchanged one is loaded as it is. No PyTorch
header is compiled, so a build takes seconds. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("flash_windowed", "flash_global", "flash_attn", "quant_matmul", "fused_mlp",
           "quant_matmul_a8", "probe_packed", "probe_heads")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' `dtype` argument
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures, one per library: (symbol, argtypes).
SIGNATURES: Dict[str, Tuple[str, Tuple]] = {
    # dtype, out_int8, qkv, rel, out, NW, L, nh, hd, kh, kw, q_scale, ois, stream
    "flash_windowed": (
        "samq_flash_windowed",
        (_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    ),
    # dtype, out_int8, q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw,
    # q_scale, ois, stream
    "flash_global": (
        "samq_flash_global",
        (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    ),
    # dtype, has_rel, body, q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw,
    # q_scale, stream
    "flash_attn": (
        "samq_flash_attn",
        (_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    ),
    # dtype, bits, x, qweight, qweight_hi, scales, zeros, out, M, K, N,
    # groupsize, pack_block, bm, bn, bk (the tile), stream
    "quant_matmul": (
        "samq_quant_matmul",
        (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    ),
    # dtype, bits, x, qw1, s1, z1, b1, qw2, s2, z2, out, hidden, M, K, H, N,
    # groupsize1, pack_block1, groupsize2, pack_block2, stream
    "fused_mlp": (
        "samq_fused_mlp",
        (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    ),
    # dtype (of out), bits, sym, xq, xs, qweight, scales, zeros, out, M, K, N,
    # groupsize, pack_block, bm, bn, bk (the tile), stream
    "quant_matmul_a8": (
        "samq_quant_matmul_a8",
        (_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    ),
    # q, k, v, rel, out, NW, L, nh, hd, R, row_stride, win_stride, scale, stream
    "probe_packed": (
        "samq_probe_no_softmax",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _F, _P),
    ),
    # mode, exp2, has_bias, q, k, v, rh, rw, out, BH, L, D, kh, kw, stream
    "probe_heads": (
        "samq_probe_heads",
        (_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    ),
}

_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}  # wall seconds of each library's last nvcc run


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return cand


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current sources."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library in parallel; return ``nvcc``'s
    diagnostics (register and shared-memory use) for each one built, and
    record its seconds in :data:`BUILD_SECONDS`.

    Raises ``RuntimeError`` with the compiler output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    jobs, start = [], time.perf_counter()
    for name in todo:
        target = library_path(name)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, target, tmp, proc))
    logs, failed = {}, []

    def wait(name, proc):
        logs[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - start

    waiters = [threading.Thread(target=wait, args=(name, proc)) for name, _, _, proc in jobs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for name, target, tmp, proc in jobs:
        out = logs[name]
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
        else:
            os.unlink(tmp)
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def tma_operands(*tensors: torch.Tensor):
    """``tensors`` (..., D) as the 16-byte copies of csrc/probe_tc.cuh (TMA)
    and of flash_attn.cu's float32 body (cp.async) take them: D padded with
    zeros to rows of whole 16-byte groups (a multiple of 8 in bfloat16, of 4
    in float32), and a copy of any operand that does not start on 16 bytes.
    Zero columns add nothing to q.k; the caller cuts the output columns they
    give."""
    pad = -tensors[0].shape[-1] % (16 // tensors[0].element_size())
    padded = (F.pad(t, (0, pad)) if pad else t for t in tensors)
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in padded]


def launch(name: str, *args) -> None:
    """Call the C entry point of library ``name`` with ``args``; raise if it
    returns a CUDA error. The caller counts the launch."""
    symbol, _ = SIGNATURES[name]
    err = getattr(load(name), symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def aoti_runner() -> Path:
    """The ``csrc/aoti_runner.cpp`` program, built with ``g++`` against this
    PyTorch at first use into ``build/torch_kernels/aoti_runner-<hash>``.
    It links ``libtorch_cuda`` and ``libc10_cuda`` where this PyTorch has
    them (kept with ``--no-as-needed``: the runner names no CUDA symbol, but
    a CUDA package needs them loaded). Raises ``RuntimeError`` with the
    compiler output if the build fails."""
    from torch.utils.cpp_extension import include_paths

    src = CSRC / "aoti_runner.cpp"
    lib_dir = Path(torch.__file__).resolve().parent / "lib"
    libs = ["torch", "torch_cpu", "c10"] + [
        n for n in ("torch_cuda", "c10_cuda") if (lib_dir / f"lib{n}.so").exists()]
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    flags = ["-O2", "-std=c++20", f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             *(f"-I{p}" for p in include_paths()), f"-L{lib_dir}", f"-Wl,-rpath,{lib_dir}",
             "-Wl,--no-as-needed", *(f"-l{n}" for n in libs)]
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"aoti_runner-{h}"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", str(src), *flags, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"aoti_runner build failed (g++ exit {proc.returncode}):\n"
                           + proc.stdout + proc.stderr)
    os.chmod(tmp, 0o755)
    os.replace(tmp, target)  # atomic: a concurrent caller never runs half a file
    return target
