"""Run a host BLAS/LAPACK call on one thread, whatever the process's
thread count.

A threaded BLAS (OpenBLAS, MKL, BLIS) splits its level-2/3 work by the
number of threads it runs, so the last bits of a blocked LAPACK routine
such as ``np.linalg.eigh`` depend on ``OMP_NUM_THREADS`` and on the
machine's core count.  ``single_threaded()`` sets every threaded BLAS
loaded into the process to one thread for the duration of a ``with``
block and restores its count afterwards.  The libraries are found among
the process's loaded shared objects (``dl_iterate_phdr``) by name; one
that is found but exposes none of the known thread-count entry points
raises.  Where no threaded BLAS is loaded there is nothing to pin.
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import os
import threading

# library name fragment -> [(setter, getter)] entry points to look for
_ENTRY_POINTS = {
    "openblas": [
        (f"{pre}openblas_set_num_threads{suf}", f"{pre}openblas_get_num_threads{suf}")
        for pre in ("scipy_", "") for suf in ("64_", "_64", "")
    ],
    "mkl_rt": [("MKL_Set_Num_Threads", "MKL_Get_Max_Threads")],
    "blis": [("bli_thread_set_num_threads", "bli_thread_get_num_threads")],
}

_LOCK = threading.RLock()
_CONTROLS = None  # [(setter, getter)] once found


class _PhdrInfo(ctypes.Structure):
    _fields_ = [("dlpi_addr", ctypes.c_size_t), ("dlpi_name", ctypes.c_char_p)]


def _loaded_libraries() -> list:
    """Paths of the shared objects loaded into this process."""
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    paths = []
    callback_t = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(_PhdrInfo),
                                  ctypes.c_size_t, ctypes.c_void_p)

    def visit(info, _size, _data):
        name = info.contents.dlpi_name
        if name:
            paths.append(os.fsdecode(name))
        return 0

    libc.dl_iterate_phdr(callback_t(visit), None)
    return paths


def _controls() -> list:
    global _CONTROLS
    if _CONTROLS is None:
        import numpy  # noqa: F401  (loads numpy's BLAS before the scan)

        found = []
        for path in _loaded_libraries():
            base = os.path.basename(path).lower()
            for frag, names in _ENTRY_POINTS.items():
                if frag not in base:
                    continue
                lib = ctypes.CDLL(path, mode=getattr(os, "RTLD_NOLOAD", 0) | ctypes.RTLD_GLOBAL)
                pair = next(((getattr(lib, s), getattr(lib, g)) for s, g in names
                             if hasattr(lib, s) and hasattr(lib, g)), None)
                if pair is None:
                    raise RuntimeError(f"{path} is a threaded BLAS but exposes none of "
                                       f"{[s for s, _ in names]}: cannot pin it to one thread")
                setter, getter = pair
                getter.restype = ctypes.c_int
                getter.argtypes = []
                setter.restype = None
                setter.argtypes = [ctypes.c_int]
                found.append(pair)
        _CONTROLS = found
    return _CONTROLS


@contextlib.contextmanager
def single_threaded():
    """Every threaded BLAS of the process runs on one thread inside."""
    with _LOCK:
        controls = _controls()
        before = [getter() for _, getter in controls]
        for setter, _ in controls:
            setter(1)
        try:
            yield
        finally:
            for (setter, _), n in zip(controls, before):
                setter(n)
