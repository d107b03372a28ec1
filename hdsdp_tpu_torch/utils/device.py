"""Device and dtype policy of the port.

Every tensor the solver allocates is float64 (the IPM uses Cholesky
success as its PSD predicate and drives gaps to 1e-8, as the reference
does in double precision) and lives on the device the caller names.
There is no silent fallback: asking for ``"cuda"`` on a machine without
a usable card raises.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64


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


def is_tpu() -> bool:
    """The JAX package's platform predicate (hdsdp_tpu/utils/platform.py),
    which turns on the tiers written for a TPU, where f64 is emulated:
    the inverted preconditioner, the double-single full-precision tier
    and the Ozaki residual of ops.cg, the DD try-Cholesky and the Ozaki
    recovery congruence of solver.dimacs, the forced DD inverse of
    ops.chol at n >= 8192, and the "auto" settings of ``cone_fp`` and
    ``kkt_fp``.  The port runs on CUDA cards and on the host, never on a
    TPU, so it is False; the gates that read it are module-level functions
    that tests force on with monkeypatch."""
    return False
