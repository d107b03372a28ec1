"""Command-line driver on one device: extension-dispatched solves.

    python -m hdsdp_tpu_torch problem.dat-s [--device cuda|cpu] [--json]
    python -m hdsdp_tpu_torch problem.mps [--device cuda|cpu] [--json]

``.dat-s`` files go to the SDP solver, ``.mps`` files to the LP solver,
as in the JAX package's CLI, whose flags it takes; ``--no-fused`` runs the
host-driven loop instead of the fused phase bodies (SDP only).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hdsdp_tpu_torch",
        description="dual-scaling interior-point SDP/LP solver (PyTorch/CUDA)",
    )
    ap.add_argument("file", help="problem file (.dat-s for SDP, .mps for LP)")
    ap.add_argument("--dual-only", action="store_true",
                    help="stop at a dual optimal solution (SDP only)")
    ap.add_argument("--quiet", action="store_true", help="suppress logs")
    ap.add_argument("--json", action="store_true",
                    help="print a one-line JSON summary")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--time-limit", type=float, default=None)
    ap.add_argument("--no-fused", action="store_true",
                    help="use the host-driven loop, not the fused phase bodies")
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    args = ap.parse_args(argv)

    fname = args.file.lower()
    overrides = {"verbose": not args.quiet}
    if args.max_iter is not None:
        overrides["max_iter"] = args.max_iter
    if args.time_limit is not None:
        overrides["time_limit"] = args.time_limit

    if fname.endswith(".mps"):
        from hdsdp_tpu_torch.solver.lpsolve import solve_mps_file

        r = solve_mps_file(args.file, device=args.device, **overrides)
        extra = {}
    elif fname.endswith(".dat-s") or fname.endswith(".dat"):
        from hdsdp_tpu_torch.solver.solver import solve_sdpa_file

        if args.no_fused:
            overrides["fused"] = False
        r = solve_sdpa_file(args.file, device=args.device, d_only=args.dual_only,
                            **overrides)
        extra = {"dimacs_max": float(abs(r.dimacs).max())}
    else:
        print(f"unrecognized extension: {args.file}", file=sys.stderr)
        return 2

    summary = {
        "status": r.status,
        "pObj": r.p_obj,
        "dObj": r.d_obj,
        "iters": r.n_iters,
        "time_s": round(r.solve_time, 3),
        **extra,
        "device": args.device,
    }
    if args.json:
        print(json.dumps(summary))
    return 0 if summary["status"] in ("PRIMAL_DUAL_OPTIMAL", "DUAL_OPTIMAL") else 1


if __name__ == "__main__":
    sys.exit(main())
