"""Build and load the port's CUDA kernels (`repro_torch/csrc/*.cu`).

Each source compiles with nvcc for sm_90a into an object file, all sources
at once in parallel, and the objects link into one shared library with a
plain C interface that ctypes loads.  The library is built at first use
into `repro_torch/build/` (ignored by git), named by a digest of the
sources and flags, so an edited source builds anew and an unchanged one
loads the existing library.

Nothing here runs at import: the CPU tests import every module, and this
host has no nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("paged_attention.cu", "dsg_ffn.cu", "drs_search.cu",
           "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dtype, q, k_new, v_new, k_pages, v_pages, page_table, pos, out,
    # b, kv, g, d, ps, max_pages, walk, window, scale, threads, smem, stream
    "repro_paged_decode": [_I] + [_P] * 8 + [_I] * 8 + [_F, _I, _I, _P],
    # q, k_new, v_new, k_pages, v_pages, page_table, pos, out, b, kv, g, d,
    # ps, max_pages, walk, window, scale, splits, stream
    "repro_paged_decode_split": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
    # dtype, x, wg, wu, wd, idx, counts, h, out, b, d, f, kslots, block, stream
    "repro_dsg_ffn_csr": [_I] + [_P] * 8 + [_I] * 5 + [_P],
    # x, wg, wu, wd, idx, counts, h, out, b, d, f, kslots, block, lanes,
    # cluster, slice, tile, splits, stream
    "repro_dsg_ffn_csr_union": [_P] * 8 + [_I] * 10 + [_P],
    # dtype, x, r, out, m, k, d, stream
    "repro_drs_project": [_I] + [_P] * 3 + [_I] * 3 + [_P],
    # x, r, out, m, k, d, shares, stream
    "repro_drs_project_gemv": [_P] * 3 + [_I] * 4 + [_P],
    # x, r, out, ws, m, k, d, chunks_per_split, splits, stream
    "repro_drs_project_tc": [_P] * 4 + [_I] * 5 + [_P],
    # dtype, fx, fw, out, m, k, f, block, rows, smem, stream
    "repro_drs_scores": [_I] + [_P] * 3 + [_I] * 6 + [_P],
    # fx, fw, out, m, k, f, block, slices, stream
    "repro_drs_scores_gemv": [_P] * 3 + [_I] * 5 + [_P],
    # fx, fw, out, m, k, f, block, per, stream
    "repro_drs_scores_tc": [_P] * 3 + [_I] * 5 + [_P],
    # dtype, x, wg, wu, wd, token_mask, live, h, out, m, d, f, block, stream
    "repro_dsg_ffn_tile": [_I] + [_P] * 8 + [_I] * 4 + [_P],
    # x, wg, wu, wd, token_mask, live, h, out, m, d, f, block, rows,
    # splits, stream
    "repro_dsg_ffn_tile_tc": [_P] * 8 + [_I] * 6 + [_P],
    # dtype, q, k, v, out, bh, s, t, d, causal, offset, scale, stream
    "repro_flash_attention": [_I] + [_P] * 4 + [_I] * 6 + [_F, _P],
    # q, k, v, out, ws_acc, ws_ml, bh, s, t, d, causal, offset, scale,
    # tiles_per_split, splits, stream
    "repro_flash_attention_tc": [_P] * 6 + [_I] * 6 + [_F] + [_I] * 2 + [_P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD / f"librepro_torch_{_digest()}.so"


def build() -> tuple:
    """Compile every source in parallel and link the library unless it
    exists.  Returns (library path, seconds spent)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [Path(tmp) / (src + ".o") for src in SOURCES]
        # each nvcc leads a process group of its own, so that a failed
        # build ends the compilers it started as well
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            process_group=0)
            for src, obj in zip(SOURCES, objs)]
        try:
            for src, proc in zip(SOURCES, procs):
                out, _ = proc.communicate()
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor is on one CUDA device; return it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise RuntimeError(
                f"{name} launches a CUDA kernel: every operand must be on "
                f"one CUDA device, got {[str(x.device) for x in tensors]}")
    return dev


def require_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def dtype_code(name: str, *tensors: torch.Tensor) -> int:
    """The kernel dtype code shared by `tensors`; raise on a mix or an
    element type the kernels do not take."""
    dt = tensors[0].dtype
    if dt not in DTYPE_CODE or any(t.dtype != dt for t in tensors):
        raise ValueError(f"{name} takes float32 or bfloat16 operands of one "
                         f"dtype, got {[str(t.dtype) for t in tensors]}")
    return DTYPE_CODE[dt]


def launch(name: str, *args) -> None:
    """Call C entry point `name` (pointers as ints) and raise on a CUDA
    error; the caller appends the stream as the last argument."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({lib.repro_error_string(err).decode()})")


_COUNT_LOCK = threading.Lock()


def count(wrapper, path: str) -> None:
    """Add one to a wrapper's `launches` and its `launches_<path>`, under a
    lock: replicas launch from worker threads, and `+=` on an attribute is
    a read-modify-write that loses counts when two threads interleave."""
    name = f"launches_{path}"
    with _COUNT_LOCK:
        wrapper.launches += 1
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def stream(device: torch.device) -> int:
    """PyTorch's current stream on `device`, read at call time, so a launch
    follows the caller's stream (and a CUDA graph's capture stream)."""
    return torch.cuda.current_stream(device).cuda_stream


def require_aligned16(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary, as TMA and
    bulk copies need."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte "
                             f"boundary for the {t.dtype} kernel")
