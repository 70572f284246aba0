"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

The sources under ``csrc/`` have a plain C interface: ``nvcc`` compiles
them for Hopper (``sm_90a``), one process per source, all started
together, and links the objects into one shared library, in a few seconds
and with no PyTorch headers. The library is built at first use, into
``build/cuda/`` at the root of the checkout (listed in ``.gitignore``),
under a name that carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bottleneck.cu", "stage.cu", "vit.cu", "attention.cu",
           "vit_block.cu", "lstm.cu", "infonce.cu", "conv_epilogue.cu")
HEADERS = ("gemm.cuh", "bottleneck.cuh", "grid.cuh", "vit.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""        # nvcc's output (ptxas: registers, shared memory, spills)
build_seconds = 0.0   # 0 when the library was already on disk


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build() -> Path:
    """Compile the kernels if this exact source and flag set has not been
    compiled yet; returns the shared library's path."""
    global build_log, build_seconds
    digest = hashlib.sha1(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"libmmb_kernels_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}")
    objs = [Path(f"{tmp}.{Path(name).stem}.o") for name in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)]
    build_log = "".join(proc.communicate()[0] for proc in procs)
    failed = [name for name, proc in zip(SOURCES, procs) if proc.returncode]
    if not failed:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", f"{tmp}.tmp",
                               *map(str, objs)],
                              capture_output=True, text=True, check=False)
        build_log += link.stdout + link.stderr
        failed = ["the link"] if link.returncode else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
    os.replace(f"{tmp}.tmp", lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            i64 = ctypes.c_longlong
            lib.mmb_bottleneck_bf16.argtypes = (
                [ptr] * 12 + [i32] * 7 + [ptr])
            lib.mmb_vit_attention_bf16.argtypes = (
                [ptr] * 11 + [i32] * 4 + [f32] * 2 + [ptr])
            lib.mmb_vit_mlp_bf16.argtypes = (
                [ptr] * 10 + [i32] * 4 + [f32, ptr])
            lib.mmb_attention_bf16.argtypes = (
                [ptr] * 4 + [i64] * 4 + [i32] * 8 + [f32, i32, ptr])
            lib.mmb_qkv_attention_bf16.argtypes = (
                [ptr] * 4 + [i32] * 4 + [f32, ptr])
            lib.mmb_vit_block_bf16.argtypes = (
                [ptr] * 20 + [i32] * 6 + [f32] * 2 + [ptr])
            lib.mmb_bottleneck_s8.argtypes = [ptr] * 17 + [i32] * 7 + [ptr]
            lib.mmb_bottleneck_t.argtypes = [ptr] * 15 + [i32] * 7 + [ptr]
            lib.mmb_bottleneck_band_bf16.argtypes = (
                [ptr] * 12 + [i32] * 9 + [ptr])
            lib.mmb_conv1x1_bn_residual_relu_bf16.argtypes = (
                [ptr] * 6 + [i32] * 3 + [ptr])
            lib.mmb_stage.argtypes = (
                [i32, i32, ptr, ptr] + [ptr] * 7 + [i32] * 7 + [ptr])
            lib.mmb_lstm_f32.argtypes = [ptr] * 10 + [i32] * 3 + [ptr]
            lib.mmb_infonce_fwd_f32.argtypes = [ptr] * 9 + [i32] * 2 + [ptr]
            lib.mmb_infonce_bwd_f32.argtypes = [ptr] * 12 + [i32] * 2 + [ptr]
            for fn in (lib.mmb_bottleneck_bf16, lib.mmb_bottleneck_s8,
                       lib.mmb_bottleneck_t, lib.mmb_bottleneck_band_bf16,
                       lib.mmb_conv1x1_bn_residual_relu_bf16,
                       lib.mmb_stage, lib.mmb_vit_attention_bf16,
                       lib.mmb_vit_mlp_bf16, lib.mmb_attention_bf16,
                       lib.mmb_qkv_attention_bf16, lib.mmb_vit_block_bf16,
                       lib.mmb_lstm_f32, lib.mmb_infonce_fwd_f32,
                       lib.mmb_infonce_bwd_f32):
                fn.restype = i32
            lib.mmb_cuda_error_string.argtypes = [i32]
            lib.mmb_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.mmb_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
