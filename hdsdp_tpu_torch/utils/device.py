"""Device and dtype policy of the port.

Every tensor the solver allocates is float64 by default (the IPM uses
Cholesky success as its PSD predicate and drives gaps to 1e-8, as the
reference does in double precision) and lives on the device the caller
names.  There is no silent fallback: asking for ``"cuda"`` on a machine
without a usable card raises.

``Params.dtype="float32"`` makes the host loop's data and first iterate
float32, as the JAX package's does (``working_dtype``).  That loop is
not float32 throughout: the JAX package runs with x64 on, where an
float32 array combined with a non-weak float64 (a numpy float64 scalar
such as the mu that ``np.sqrt`` leaves in phase B, or a float64 array,
even 0-dim) becomes float64, and from then on everything it touches.
torch promotes neither (it treats numpy scalars and 0-dim tensors as
weak, and its products refuse mixed operands), so the port asks for the
JAX package's result dtype where the two differ (``jdtype``) and casts
its operands to it (``jcast``).
"""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float64


def working_dtype(name: str) -> torch.dtype:
    """The IPM's dtype for ``Params.dtype``, as the JAX package picks it
    (hdsdp_tpu/solver/algo.py:71): float64 for "float64", else float32."""
    return torch.float64 if name == "float64" else torch.float32


def _strong64(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.float64
    return isinstance(x, np.floating) and x.dtype == np.float64


def jdtype(*xs) -> torch.dtype:
    """The floating dtype the JAX package's promotion (x64 on) gives an
    operation on ``xs``: float64 when any is a float64 tensor (of any
    rank) or a numpy float64 scalar, else float32 when any is a float32
    tensor, else float64.  Python numbers and None are weak: they count
    for nothing."""
    f32 = False
    for x in xs:
        if _strong64(x):
            return torch.float64
        f32 = f32 or (isinstance(x, torch.Tensor) and x.dtype == torch.float32)
    return torch.float32 if f32 else torch.float64


def jcast(dt: torch.dtype, *ts):
    """The floating tensors of ``ts`` cast to ``dt`` (others as they are),
    as a tuple."""
    return tuple(t.to(dt) if isinstance(t, torch.Tensor) and t.is_floating_point()
                 and t.dtype != dt else t for t in ts)


def jlift(*ts, by=()):
    """``ts`` cast to the dtype the JAX package would compute with them
    and the host scalars ``by``: ``jcast(jdtype(*ts, *by), *ts)``."""
    return jcast(jdtype(*ts, *by), *ts)


def jdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype (torch refuses mixed operands)."""
    a, b = jlift(a, b)
    return a @ b


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev

