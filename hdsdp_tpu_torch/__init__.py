"""hdsdp_tpu_torch: the dual-scaling interior-point SDP solver on PyTorch.

A port of the JAX package ``hdsdp_tpu`` (which stays the reference) to
PyTorch and hand-written CUDA kernels for an NVIDIA H100:

  min <C, X>  s.t.  A(X) = b,  X in (product of SDP / LP / bound cones)

solved by the three-phase dual interior-point method (infeasible-start
dual IPM, homogeneous self-dual embedding, dual potential reduction): by
default as the fused, device-resident phase bodies of ``solver/fused.py``
wherever their state fits the JAX package's memory budget, else (and in
matrix-free operator mode, or with ``fused=False``) by the host-driven
loop of ``solver/algo.py``.  Beside it: the standalone LP interior-point
solver for MPS files (``solve_mps_file``, ``LPSolver``), checkpoint and
resume (``HDSDPSolver.optimize(resume_from=..., checkpoint_to=...)``) and
the KKT cross-check (``kkt_cross_validate``), and ``solve_batch``: a
fleet of same-shape SDPs through one set of fused phase bodies.

Policy: every tensor is float64 on the device the caller names, unless
``dtype="float32"`` asks for the JAX package's float32 host loop; the
public entry points default to ``device="cuda"`` and raise when no card
is usable (pass ``device="cpu"`` explicitly to run on the host).  The
package imports neither jax nor hdsdp_tpu.
"""

import torch

# The f32 Lanczos ratio test and the plain Ozaki pair products rely on
# full-precision f32 matmuls on the card: never TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from hdsdp_tpu_torch.io.mps import read_mps  # noqa: E402
from hdsdp_tpu_torch.io.sdpa import read_sdpa, write_sdpa  # noqa: E402
from hdsdp_tpu_torch.models.problem import SDPProblem  # noqa: E402
from hdsdp_tpu_torch.solver.batch import solve_batch  # noqa: E402
from hdsdp_tpu_torch.solver.lpsolve import LPParams, LPSolver, solve_mps_file  # noqa: E402
from hdsdp_tpu_torch.solver.solver import HDSDPSolver, solve_sdpa_file  # noqa: E402
from hdsdp_tpu_torch.utils.device import DTYPE, resolve_device  # noqa: E402
from hdsdp_tpu_torch.utils.kktcheck import kkt_cross_validate  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DTYPE",
    "HDSDPSolver",
    "LPParams",
    "LPSolver",
    "SDPProblem",
    "kkt_cross_validate",
    "read_mps",
    "read_sdpa",
    "resolve_device",
    "solve_batch",
    "solve_mps_file",
    "solve_sdpa_file",
    "write_sdpa",
]
