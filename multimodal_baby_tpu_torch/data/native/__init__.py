"""ctypes bindings for the native C++ image decoder (counterpart of
``multimodal_baby_tpu/data/native``; ``image_pipeline.cc`` is a copy of
its source, byte for byte).

JPEG and PNG decode with libjpeg and libpng, a bilinear resize to the
target size, and a thread pool for a batch, outside the interpreter lock.
The library is built with g++ at first use into ``build/native/`` at the
root of the checkout (listed in ``.gitignore``), under a name that carries
a hash of the source and the flags. The compiler writes a temporary file
that is then renamed onto that name, so processes that build at once each
load a whole library. Where g++, libjpeg or libpng is missing, the build
fails, ``available()`` is False, ``build_error()`` says why, and the
decoders return None: the datasets then decode with PIL, as the JAX
package does.

``fast`` selects the DCT-scaled JPEG decode: libjpeg runs its inverse DCT
at the smallest M/8 scale whose output still covers the target (2-4x
cheaper on downscales; a 256 px frame lands on 224 at M = 7 and skips the
resize). It is a few u8 LSB off the full decode and bilinear resize, the
same class of approximation as PIL's ``Image.draft()``; ``fast=False`` is
the exact path. The JAX package reads the same choice from
``MMB_FAST_DECODE`` (default on); here it is an argument.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "image_pipeline.cc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")
FAST_SCALE = 1  # image_pipeline.cc: kFastScale

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_tried = False


def library_path() -> Path:
    """Where this source and flag set is built."""
    digest = hashlib.sha1(" ".join(FLAGS + LIBS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmmb_image_pipeline_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder unless this exact source and flag set is built;
    returns the library's path. Raises RuntimeError when g++ fails."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ did not run: {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{(proc.stderr or proc.stdout).strip()}")
    os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.decode_image_opts.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.decode_image_opts.restype = ctypes.c_int
        lib.decode_batch3.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int]
        lib.decode_batch3.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native decoder is built and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the decoder is unavailable (the build's or the loader's
    message), or None when it loaded."""
    _load()
    return _error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_image(path: str, size: int = 224,
                 fast: bool = True) -> Optional[np.ndarray]:
    """Decode and resize one image to [size, size, 3] uint8; None when the
    file does not decode or the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.decode_image_opts(str(path).encode(), _ptr(out), size, size,
                               FAST_SCALE if fast else 0)
    return out if rc == 0 else None


def _decode(lib, paths: Sequence[str], size: int, n_threads: int,
            fast: bool, ok: Optional[np.ndarray]) -> np.ndarray:
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 4)
    lib.decode_batch3(names, n, _ptr(out), size, size, n_threads,
                      None if ok is None else _ptr(ok),
                      FAST_SCALE if fast else 0)
    return out


def decode_batch(paths: List[str], size: int = 224, n_threads: int = 0,
                 fast: bool = True) -> Optional[np.ndarray]:
    """Decode and resize a batch -> [N, size, size, 3] uint8, the failed
    slots zero-filled; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return _decode(lib, paths, size, n_threads, fast, None)


def decode_batch_checked(paths: List[str], size: int = 224,
                         n_threads: int = 0, fast: bool = True
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Like ``decode_batch``, and also a per-slot mask ([N] uint8, 1 =
    decoded), so that a caller can send the failed slots through another
    decoder. None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ok = np.empty((len(paths),), np.uint8)
    return _decode(lib, paths, size, n_threads, fast, ok), ok
