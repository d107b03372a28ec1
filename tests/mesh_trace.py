"""The port's iteration log on the CPU, on a mesh or on one device, and
the comparison of two logs: where the trajectories of two runs part.

    python tests/mesh_trace.py solve gpp500 --mesh 1 --kw '{"kkt_hp": "off"}' > port.json
    JAX_PLATFORMS=cpu python tests/jax_reference.py gpp500 --mesh 1 --rows 1000 \\
        --kw '{"kkt_hp": "off"}' > jax.json
    python tests/mesh_trace.py compare port.json jax.json

``solve`` runs a named instance of ``hdsdp_tpu_torch/utils/instances.py``
with its overrides and ``--kw`` on the CPU: with ``--mesh N`` on a gloo
world of N ranks (``parallel.mesh.spawn``, the host loop every mesh
runs), else on one device with ``fused=False``; it prints one JSON line in
the form of ``tests/jax_reference.py --rows``, every log row included.
``compare`` reads two such lines and prints their status and iterations,
the first row where d_obj or mu differ by more than 1e-12, 1e-9, 1e-6 and
1e-3 relative, and each run's phase-B steps below 1e-3 (the fourth ends
phase B as NUMERICAL, ``algo.py``'s small-step rule).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hdsdp_tpu_torch.utils.instances import INSTANCES  # noqa: E402

TOLS = (1e-12, 1e-9, 1e-6, 1e-3)


def solve(name: str, mesh, kw) -> dict:
    from hdsdp_tpu_torch.parallel import run

    gen, kwargs, overrides = INSTANCES[name]
    overrides = dict(overrides, **(kw or {}))
    t0 = time.time()
    if mesh:
        from hdsdp_tpu_torch.parallel.mesh import spawn

        r = spawn(run.calls, mesh, "gloo", "cpu",
                  [("solve", dict(gen=gen, kwargs=kwargs, overrides=overrides))])[0]
        out = {k: r[k] for k in ("status", "iterations", "d_obj", "p_obj", "cones")}
        out["dimacs_max"] = float(abs(r["dimacs"]).max())
        rows = r["log_rows"]
    else:
        from hdsdp_tpu_torch.solver.solver import HDSDPSolver
        from hdsdp_tpu_torch.utils.log import Logger

        s = HDSDPSolver(run.problem(gen, kwargs), device="cpu", fused=False, verbose=False,
                        **overrides)
        with run.log_rows(Logger) as rows:
            r = s.optimize()
        out = {"status": r.status, "iterations": r.n_iters, "d_obj": r.d_obj, "p_obj": r.p_obj,
               "cones": type(s.ipm.cones).__name__, "dimacs_max": float(abs(r.dimacs).max())}
    return {"instance": name, "package": "hdsdp_tpu_torch", "overrides": overrides,
            "mesh": mesh, **out, "cpu_wall_s": time.time() - t0, "rows": rows}


def compare(a: dict, b: dict) -> dict:
    first = {}
    for x, y in zip(a["rows"], b["rows"]):
        if tuple(x[:2]) != tuple(y[:2]):
            first["rows_differ"] = [x[:2], y[:2]]
            break
        rel = max(abs(x[k] - y[k]) / abs(y[k]) for k in (2, 3))
        for t in TOLS:
            if rel > t and str(t) not in first:
                first[str(t)] = {"method": x[0], "iteration": x[1], "rel": rel}

    def small(d):
        return [(r[1], r[4]) for r in d["rows"] if r[0] == "potential" and r[4] < 1e-3]

    return {"status": [a["status"], b["status"]], "iterations": [a["iterations"], b["iterations"]],
            "d_obj": [a["d_obj"], b["d_obj"]], "first_row_over": first,
            "small_steps": [small(a), small(b)]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("solve")
    sp.add_argument("name", choices=sorted(INSTANCES))
    sp.add_argument("--mesh", type=int, default=None, help="ranks of a gloo world on the CPU")
    sp.add_argument("--kw", type=json.loads, default=None, help="more solver overrides (JSON)")
    cp = sub.add_parser("compare")
    cp.add_argument("a")
    cp.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "solve":
        print(json.dumps(solve(args.name, args.mesh, args.kw)))
    else:
        def load(path):
            with open(path) as f:
                return json.loads(f.read().strip().splitlines()[-1])
        print(json.dumps(compare(load(args.a), load(args.b))))
