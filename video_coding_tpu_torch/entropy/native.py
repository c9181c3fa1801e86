"""ctypes bindings for the port's host entropy engine
(``csrc/host_entropy.cpp``, a copy of the JAX package's C++ engine).

At first use the source is compiled with ``g++ -O3 -std=c++17 -fPIC
-shared -pthread`` into a shared library under ``build/torch_kernels/`` at
the checkout root, named after a hash of the source (so an edited source
is never served by a stale build), and loaded with ctypes. It is a
library of its own, apart from the nvcc-built kernels: it builds and runs
on any host with a C++ compiler, with or without a GPU.

Nothing falls back: ``load()`` raises with the compiler's output when the
build fails, and on an ABI mismatch. ``available()`` only reports whether
the library builds; the scan tier (``entropy/scan.py``) runs its pure
Python / numpy versions only when the caller passes ``use_native=False``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..kernels import BUILD_DIR, CSRC

SOURCE = CSRC / "host_entropy.cpp"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
# Must match vct_version() in csrc/host_entropy.cpp.
ABI_VERSION = 7

_lock = threading.Lock()
_lib = None


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libvct_host_entropy_{digest}.so"


def build():
    """Compile the engine (a no-op when the library for this source
    exists). Raises RuntimeError with the compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host entropy engine cannot "
                           "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    run = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed for host_entropy.cpp:\n"
                           + run.stdout.decode(errors="replace"))
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32

    def p(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

    p_u8, p_i16, p_i32, p_i64, p_u16 = (p(np.uint8), p(np.int16),
                                        p(np.int32), p(np.int64),
                                        p(np.uint16))
    tables = [p_i32, p_i32, p_i64,       # dc maxbits, lut, offsets
              p_i32, p_i32, p_i64]       # ac maxbits, lut, offsets
    decode = [p_u8, p_i64, i64,          # data, seg_offsets, n_segments
              p_i32, i64, i64, i32,      # comp_idx, n_blocks, b/seg, n_comp
              *tables]
    encode = [p_i32, i64, i64, i64, i32,  # comp_idx, n_blocks, b/seg, n_seg,
                                          # n_comp
              p_u16, p_u8, p_u16, p_u8,   # dc bits/len, ac bits/len
              p_u8, i64, p_i64, i32]      # out, seg_stride, seg_lens, threads
    signatures = {
        "vct_decode_blocks": (i64, decode + [p_i32, i32]),
        "vct_decode_blocks_resync": (i64, decode + [p_i32, p_i64, i32]),
        "vct_encode_blocks": (i64, [p_i32] + encode),
        "vct_encode_blocks_i16": (i64, [p_i16] + encode),
        "vct_assemble_stream": (i64, [p_u8, i64, p_i64, i64, p_u8]),
        "vct_index_scan": (i64, [p_u8, i64, p_i32, i64, i32, *tables,
                                 i64, p_i64, p_i32]),
        "vct_destuff_segments": (i64, [p_u8, i64, p_u8, p_i64, i64]),
        "vct_destuff_segments_m": (i64, [p_u8, i64, p_u8, p_i64, p_i64,
                                         i64]),
        "vct_pack_lanes": (None, [p_u8, p_i64, p_i64, p_i32, i64, i64,
                                  p_u8]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load() -> ctypes.CDLL:
    """The loaded engine, built first if needed. Raises RuntimeError when
    the build fails or the library's ABI version is not ``ABI_VERSION``."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            lib.vct_version.restype = ctypes.c_int32
            version = lib.vct_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"{path}: ABI version {version}, "
                                   f"expected {ABI_VERSION}")
            _bind(lib)
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the engine builds and loads on this host."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True
