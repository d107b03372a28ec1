"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/hdsdp_tpu_torch/`` at the repository root, the first time a CUDA
tensor needs it, and loaded with ``ctypes``.  The library name carries a
hash of the source and the flags, so an edited source is rebuilt.
Nothing here runs at import time, and a missing ``nvcc`` or a failed
build raises: there is no fallback to the plain versions on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "hdsdp_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# kernel -> {entry point: argtypes}; every entry point returns a cudaError
SIGNATURES = {
    # a, b, ch, cl, c64, ea, eb | M, N, K, gmax, fleet size | a, b and
    # output strides, each with its fleet stride first | stream
    "hpmm_pairs": {"hpmm_pairs_launch": [_PTR] * 7 + [_INT] * 5 + [_LL] * 11 + [_PTR]},
    # x (or h), l, out, e | I, K, Kp, q, fleet size | strides of x and l,
    # each with its fleet stride first | stream
    "hpmm_slice": {"hpmm_slice_launch": [_PTR] * 4 + [_INT] * 5 + [_LL] * 6 + [_PTR]},
    # ph, pl (read), lh, ll, wh, wl | B, number of panels | stream
    "dd_panel": {"dd_panel_launch": [_PTR] * 6 + [_INT] * 2 + [_PTR]},
}

# name -> (ctypes library, build record); filled on first use
_LOADED: dict = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin (or the toolkit's default
    /usr/local/cuda); raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "cannot be built"
    )


def build(name: str) -> dict:
    """Compile csrc/<name>.cu unless an up-to-date library exists.

    Returns {"path", "seconds", "log"}: seconds is 0.0 and log empty when
    the library was already built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return {"path": out, "seconds": seconds, "log": log}


def build_all(names=None) -> dict:
    """Build several kernels at once, one nvcc process each, all started
    together; returns {name: build record}."""
    names = list(SIGNATURES) if names is None else list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str):
    """(ctypes.CDLL, build record) for csrc/<name>.cu, built on first use.

    The entry points' ``restype``/``argtypes`` (``SIGNATURES``) are set
    once, here, so a launch pays for no ctypes set-up and no pointer is
    ever passed as a 32-bit int."""
    if name not in _LOADED:
        rec = build(name)
        lib = ctypes.CDLL(str(rec["path"]))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int  # a cudaError
            fn.argtypes = argtypes
        _LOADED[name] = (lib, rec)
    return _LOADED[name]
