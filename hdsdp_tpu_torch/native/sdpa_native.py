"""ctypes binding of the C++ SDPA tokenizer (``sdpa_parser.cpp``).

``build()`` compiles the source with ``g++ -O2 -shared -fPIC -std=c++17``
into ``build/hdsdp_tpu_torch/libsdpa_parser-<hash>.so`` (the hash covers
the source and the flags, so an edited source is rebuilt; the library is
written under a temporary name and renamed into place, so concurrent
builders never load half a file).  ``parse(path)`` returns the raw arrays
of the file and raises ``ValueError`` with the parser's message for a
malformed file, ``RuntimeError`` with the compiler's for a failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from hdsdp_tpu_torch.ops.cuda_build import BUILD_DIR

SRC = Path(__file__).resolve().with_name("sdpa_parser.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_ERR_LEN = 512

_LIB = None


def build() -> Path:
    """Path of the built library, compiling it unless it is up to date."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libsdpa_parser-{digest}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native SDPA reader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.hdsdp_sdpa_parse.restype = ctypes.c_void_p
        lib.hdsdp_sdpa_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.hdsdp_sdpa_m.restype = ctypes.c_int32
        lib.hdsdp_sdpa_m.argtypes = [ctypes.c_void_p]
        lib.hdsdp_sdpa_nblocks.restype = ctypes.c_int32
        lib.hdsdp_sdpa_nblocks.argtypes = [ctypes.c_void_p]
        lib.hdsdp_sdpa_nnz.restype = ctypes.c_int64
        lib.hdsdp_sdpa_nnz.argtypes = [ctypes.c_void_p]
        lib.hdsdp_sdpa_export.restype = None
        lib.hdsdp_sdpa_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
        lib.hdsdp_sdpa_free.restype = None
        lib.hdsdp_sdpa_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def parse(path: str):
    """(m, dims, b, con, blk, row, col, val) of an SDPA file: dims as
    written (negative = LP block), the entries 0-based in blk, row and col
    with |val| < 1e-12 dropped and the objective not yet negated."""
    lib = _load()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h = lib.hdsdp_sdpa_parse(os.fsencode(path), err, _ERR_LEN)
    if not h:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        m = lib.hdsdp_sdpa_m(h)
        nnz = lib.hdsdp_sdpa_nnz(h)
        dims = np.zeros(lib.hdsdp_sdpa_nblocks(h), dtype=np.int32)
        b = np.zeros(m, dtype=np.float64)
        con, blk, row, col = (np.zeros(nnz, dtype=np.int32) for _ in range(4))
        val = np.zeros(nnz, dtype=np.float64)
        lib.hdsdp_sdpa_export(h, *(a.ctypes.data for a in (dims, b, con, blk, row, col, val)))
    finally:
        lib.hdsdp_sdpa_free(h)
    return int(m), dims, b, con, blk, row, col, val
