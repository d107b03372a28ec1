"""The JAX package's answer for a named instance of the port's card-side
scripts: where the reference objectives and iteration counts in
``chip_smoke.py`` come from.

    JAX_PLATFORMS=cpu python tests/jax_reference.py theta-m25001
    JAX_PLATFORMS=cpu python tests/jax_reference.py maxG51 --fused auto
    JAX_PLATFORMS=cpu python tests/jax_reference.py --lp lp1800
    JAX_PLATFORMS=cpu python tests/jax_reference.py gpp500 --fused auto --seed 1
    JAX_PLATFORMS=cpu python tests/jax_reference.py gpp500 --batch 4
    JAX_PLATFORMS=cpu python tests/jax_reference.py maxG51 --mesh 4
    JAX_PLATFORMS=cpu python tests/jax_reference.py maxG51 --fused auto --kw '{"cone_fp": "dd"}'
    JAX_PLATFORMS=cpu python tests/jax_reference.py maxG51 --kw '{"kkt_fp": "dd", "cone_fp": "dd"}'

Solves the instance's generator call (``hdsdp_tpu_torch/utils/instances.py``)
with ``hdsdp_tpu``'s ``HDSDPSolver(prob, fused=...)`` and the instance's
overrides (``--seed`` replaces the generator's seed: the other members of
a ``chip_smoke.py`` fleet), on the CPU, and prints one JSON line.  ``--fused`` defaults to
``false``, the host loop (``FAMILY_REFS``, ``OPERATOR_JAX_REF``);
``--fused auto`` takes the JAX package's default mode, the fused
programs below its memory budget (``FUSED_REFS``).  The largest instance
(theta-m25001, operator mode) holds about 19 GB and takes a quarter of an
hour on 8 cores.

``--batch N`` solves the generator at seeds 0..N-1 as one fleet with the
JAX package's ``solve_batch`` and the instance's overrides, and prints
one JSON line: each member's status, iterations and objective, and which
members its fleet finished and which it re-solved solo (the fleets of
``chip_smoke.py``'s ``[batch]`` phase); ``--kw`` adds overrides to the
fleet's too (``--batch 4 --kw '{"kkt_mp": "on"}'``).

``--mesh N`` solves on the JAX package's mesh path,
``HDSDPSolver(prob, mesh=make_mesh(N))``, over N virtual CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=N`` is set before jax
is imported): the host loop with the row-sharded or slot-partitioned
assembly and the distributed factor (``MESH_REFS`` in ``chip_smoke.py``).
``--kw '{"kkt_mode": "free"}'`` adds solver overrides to the instance's
(the double-single options of ``chip_smoke.py``'s ``[dd]`` phase,
``DD_SOLVES``, with or without a mesh);
``--rows K`` adds the iteration log's rows up to iteration K, as
(method, iteration, d_obj, mu, step) (``MESH_ROWS``; ``tests/mesh_trace.py``
solves the same on the port and compares two such lines).

``--lp NAME`` solves a named LP instance instead
(``LP_INSTANCES`` of the same module, written to an MPS file and read
back) with the JAX package's ``read_mps`` and ``LPSolver``, as its
``solve_mps_file`` runs them, once with the primal phase allowed from the
first iteration that qualifies (``primal_switch_ratio=0.0``) and once with
it forbidden (``1e30``), and prints one JSON line each (``LP_JAX_REFS`` in
``chip_smoke.py``).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mesh_devices_before_jax(argv) -> None:
    """--mesh N needs N host devices, which XLA reads once, at import."""
    if "--mesh" in argv:
        n = argv[argv.index("--mesh") + 1]
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()


if __name__ == "__main__":
    _mesh_devices_before_jax(sys.argv)

from hdsdp_tpu.io.mps import read_mps  # noqa: E402
from hdsdp_tpu.models import synthetic  # noqa: E402
from hdsdp_tpu.models.problem import SDPProblem  # noqa: E402
from hdsdp_tpu.solver.lpsolve import LPParams, LPSolver  # noqa: E402
from hdsdp_tpu.solver.solver import HDSDPSolver  # noqa: E402
from hdsdp_tpu.utils.log import Logger  # noqa: E402
from hdsdp_tpu_torch.parallel.run import log_rows  # noqa: E402
from hdsdp_tpu_torch.utils.instances import (  # noqa: E402
    INSTANCES,
    LP_INSTANCES,
    write_lp_instance,
)

FUSED = {"false": False, "auto": "auto", "phase": "phase", "iter": "iter"}


def main(name: str, fused, seed=None, mesh=None, kw=None, rows=0) -> int:
    gen, kwargs, overrides = INSTANCES[name]
    overrides = dict(overrides, **(kw or {}))
    if seed is not None:
        kwargs = dict(kwargs, seed=seed)
    t0 = time.time()
    prob = SDPProblem.from_sdpa(getattr(synthetic, gen)(**kwargs))
    if mesh:
        from hdsdp_tpu.parallel import make_mesh

        solver = HDSDPSolver(prob, mesh=make_mesh(mesh), verbose=False, **overrides)
        fused = "auto (a mesh runs the host loop)"
    else:
        solver = HDSDPSolver(prob, fused=fused, verbose=False, **overrides)
    with log_rows(Logger) as log:
        r = solver.optimize()
    print(json.dumps({
        "instance": name, "generator": gen, "kwargs": kwargs, "overrides": overrides,
        "mesh": mesh, "cones": type(solver.ipm.cones).__name__,
        "fused": fused, "status": r.status, "iterations": r.n_iters, "d_obj": r.d_obj,
        "p_obj": r.p_obj, "dimacs_max": float(abs(r.dimacs).max()),
        "psdp_ended_the_solve": solver.ipm.psdp is not None,
        "stats": {k: v for k, v in r.stats.items() if isinstance(v, (int, float))},
        "cpu_wall_s": time.time() - t0,
        **({"rows": [row for row in log if row[1] <= rows]} if rows else {}),
    }))
    return 0


def main_batch(name: str, n: int, kw=None) -> int:
    from hdsdp_tpu.solver import batch

    gen, kwargs, overrides = INSTANCES[name]
    overrides = dict(overrides, **(kw or {}))
    probs = [SDPProblem.from_sdpa(getattr(synthetic, gen)(**dict(kwargs, seed=s)))
             for s in range(n)]
    resolved = []

    class Solo(HDSDPSolver):
        def optimize(self):
            resolved.append(self.prob)
            return super().optimize()

    batch.HDSDPSolver = Solo
    t0 = time.time()
    rs = batch.solve_batch(probs, **overrides)
    print(json.dumps({
        "instance": name, "generator": gen, "kwargs": kwargs, "seeds": list(range(n)),
        "overrides": overrides, "status": [r.status for r in rs],
        "iterations": [r.n_iters for r in rs], "d_obj": [r.d_obj for r in rs],
        "dimacs_max": [float(abs(r.dimacs).max()) for r in rs],
        "resolved_solo": [any(p is q for q in resolved) for p in probs],
        "cpu_wall_s": time.time() - t0,
    }))
    return 0


def main_lp(name: str) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name + ".mps")
        write_lp_instance(name, path)
        data = read_mps(path)
    A = np.zeros((data.nrow, data.ncol))
    for j in range(data.ncol):
        lo, hi = data.col_ptr[j], data.col_ptr[j + 1]
        A[data.row_idx[lo:hi], j] += data.val[lo:hi]
    for ratio in (0.0, 1e30):
        t0 = time.time()
        solver = LPSolver(A, data.b, data.c, LPParams(verbose=False, primal_switch_ratio=ratio))
        r = solver.optimize()
        print(json.dumps({
            "lp_instance": name, "spec": LP_INSTANCES[name], "primal_switch_ratio": ratio,
            "status": r.status, "iterations": r.n_iters, "last_method": solver.last_method,
            "p_obj": data.objsense * r.p_obj + data.obj_shift,
            "d_obj": data.objsense * r.d_obj + data.obj_shift,
            "cpu_wall_s": time.time() - t0,
        }))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", nargs="?", choices=sorted(INSTANCES))
    ap.add_argument("--fused", choices=sorted(FUSED), default="false")
    ap.add_argument("--lp", choices=sorted(LP_INSTANCES))
    ap.add_argument("--seed", type=int, default=None, help="replace the generator's seed")
    ap.add_argument("--batch", type=int, default=None, help="solve seeds 0..N-1 as one fleet")
    ap.add_argument("--mesh", type=int, default=None, help="solve on a mesh of N CPU devices")
    ap.add_argument("--kw", type=json.loads, default=None, help="more solver overrides (JSON)")
    ap.add_argument("--rows", type=int, default=0,
                    help="print the log rows up to this iteration")
    args = ap.parse_args()
    if (args.name is None) == (args.lp is None):
        ap.error("give one instance NAME or one --lp NAME")
    if args.lp:
        sys.exit(main_lp(args.lp))
    if args.batch:
        sys.exit(main_batch(args.name, args.batch, args.kw))
    sys.exit(main(args.name, FUSED[args.fused], args.seed, args.mesh, args.kw, args.rows))
