"""Build and load the port's CUDA kernels (K1-K9 and the decode lookup
table that K1, K5, K6 and K7 share).

The sources in ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per source, all
started together, then one link — into a shared library under
``build/torch_kernels/`` at the checkout root, and loaded with ctypes.
The library name carries a hash of the sources, so an edited source is
never served by a stale build. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("huffman_decode.cu", "decode_datapath.cu", "encode_datapath.cu",
           "huffman_encode.cu", "huffman_decode_padded.cu",
           "huffman_decode_streamed.cu", "huffman_decode_staged.cu",
           "pack_stuff.cu", "table_lookup.cu", "huffman_lut.cu")
HEADERS = ("huffman_decode_common.cuh", "huffman_decode_lut.cuh",
           "huffman_decode_sync.cuh")
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # flat, flat_len, starts, lens, seg_blocks, S, comp_sched, B, C, lo, hi,
    # offset, T, values, V, lut, max_steps, init_bitpos, init_dc, out,
    # stream
    "vct_k1_huffman_decode": (_P, _L, _P, _P, _P, _I, _P, _I, _I, _P, _P,
                              _P, _I, _P, _I, _P, _I, _P, _P, _P, _P),
    # lo, hi, offset, T, values, V, lut, stream
    "vct_huffman_lut": (_P, _P, _P, _I, _P, _I, _P, _P),
    # coefs, quant, N, P, out, stream
    "vct_k2_decode_datapath": (_P, _P, _I, _I, _P, _P),
    # pixels, quant, N, P, out, stream
    "vct_k3_encode_datapath": (_P, _P, _I, _I, _P, _P),
    # qc, valid, S, B, comp_sched, C, dctab, actab, m_out, out, lens,
    # overflow, stream
    "vct_k4_huffman_encode": (_P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _P,
                              _P, _P),
    # segbytes, S, L, seg_blocks, comp_sched, B, C, lo, hi, offset, T,
    # values, V, lut, max_steps, regime, sub_bits, scratch, stats, out,
    # stream
    "vct_k5_huffman_decode_padded": (_P, _I, _I, _P, _P, _I, _I, _P, _P, _P,
                                     _I, _P, _I, _P, _I, _I, _I, _P, _P, _P,
                                     _P),
    # segbytes, S, L, seg_blocks, comp_sched, B, C, lo, hi, offset, T,
    # values, V, lut, sub_bits, n_sub_max, scratch, stats, out, stream
    "vct_k6_huffman_decode_streamed": (_P, _I, _I, _P, _P, _I, _I, _P, _P,
                                       _P, _I, _P, _I, _P, _I, _I, _P, _P,
                                       _P, _P),
    # flat, flat_len, starts, lens, seg_blocks, S, comp_sched, B, C, lo, hi,
    # offset, T, values, V, lut, max_steps, init_bitpos, init_dc, out, stream
    "vct_k7_huffman_decode_staged": (_P, _L, _P, _P, _P, _I, _P, _I, _I, _P,
                                     _P, _P, _I, _P, _I, _P, _I, _P, _P, _P,
                                     _P),
    # c_hi, c_lo, c_len, raw_bytes_len, S, K, m_raw, m_out, out, out_lens,
    # overflow, stream
    "vct_k8_pack_stuff": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # table, T, idx, n, out, stream
    "vct_k9_table_lookup": (_P, _I, _P, _L, _P, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libvct_kernels_{_source_hash()}.so"


def build() -> pathlib.Path:
    """Compile every source in parallel and link the shared library (a
    no-op when the library for these sources exists). The compiler's
    per-kernel register and shared-memory report (-Xptxas -v) goes to
    ``build.log`` beside the library."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    tag = lib.stem
    for name in SOURCES:
        obj = BUILD_DIR / f"{tag}_{pathlib.Path(name).stem}.o"
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for name, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out.decode(errors='replace')}")
        if p.returncode != 0:
            failed.append(name)
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib)
    return lib


def ptx(source: str) -> str:
    """PTX of one source (``nvcc -ptx`` for ``sm_90a``), written beside the
    library under the build directory; raises without ``nvcc``."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{pathlib.Path(source).stem}_{_source_hash()}.ptx"
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run(
            [nvcc, "-arch=sm_90a", "-std=c++17", "-O3", "-ptx",
             str(CSRC / source), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc -ptx failed for {source}:\n"
                               + run.stdout.decode(errors="replace"))
        os.replace(tmp, out)
    return out.read_text()


def sass(kernel_names: tuple[str, ...]) -> str:
    """SASS of the named kernels in the built library (``cuobjdump
    -sass``): each function whose mangled name holds one of the names."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        raise RuntimeError("cuobjdump not found: the SASS cannot be shown")
    lib = build()
    cached = lib.with_suffix(".sass")     # one dump of the library
    if not cached.exists():
        tmp = cached.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(subprocess.run(
            [tool, "-sass", str(lib)], check=True, stdout=subprocess.PIPE,
            text=True).stdout)
        os.replace(tmp, cached)
    dump = cached.read_text()
    keep, out = False, []
    for line in dump.splitlines():
        if "Function :" in line:
            keep = any(k in line for k in kernel_names)
        if keep:
            out.append(line)
    return "\n".join(out)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on PyTorch's current CUDA stream (passed as
    the last argument) and raise if the launch reported a CUDA error."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(load(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
