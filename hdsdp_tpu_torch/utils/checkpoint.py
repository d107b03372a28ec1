"""Checkpoint / resume of the IPM state.

The reference has no checkpointing (SURVEY.md section 5); its closest
feature is the dual warm start ``HDSDPSetDualStart`` (ref
interface/hdsdp.c:617-624).  The restartable state (the dual iterate
(y, tau), residual Rd, barrier mu, perturbation, and both primal solution
makers) is saved as an .npz and can seed a new solve.  The format is the
JAX package's (``FORMAT_VERSION`` 1, the same keys and dtypes), so a
checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import numpy as np

FORMAT_VERSION = 1


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if x is not None else np.zeros(0)


def save_checkpoint(path: str, ipm) -> None:
    """Serialize the restartable state of a ``DualIPM``."""
    mk = ipm.maker_acc
    mk2 = ipm.maker_inacc
    np.savez(
        path,
        version=FORMAT_VERSION,
        m=ipm.m,
        y=_host(ipm.y),
        tau=ipm.tau,
        rd=ipm.Rd,
        mu=ipm.mu,
        perturb=ipm.perturb,
        n_iter=ipm.n_iter,
        status=ipm.status,
        maker_acc_mu=mk.mu,
        maker_acc_y=_host(mk.y),
        maker_acc_dy=_host(mk.dy),
        maker_inacc_mu=mk2.mu,
        maker_inacc_y=_host(mk2.y),
        maker_inacc_dy=_host(mk2.dy),
    )


def load_checkpoint(path: str) -> dict:
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        out = {k: z[k] for k in z.files}
    return out


def apply_checkpoint(ipm, ckpt: dict) -> None:
    """Seed a DualIPM with a saved state: the dual warm start y0 and both
    makers (``algo.load_state(..., warm_start=True)``)."""
    from hdsdp_tpu_torch.solver.algo import load_state

    load_state(ipm, ckpt, warm_start=True)
