"""The lower-precision control of a cell, at the cell's own size.

    python3 -m sdpbench.control --workload NAME --seeds 1 2 3 [--kinds reference32,program32]

For each seed it draws the cell's pool as a run does, answers every
instance of it in a precision below the configuration's float64, and
judges those answers with the run's own comparison (``sdpbench.check``):
the control has to come out not correct.  Kinds:

  - ``reference32``: the plain reference's interior-point method in
    float32, put in the program's place (fleet cells: y and the
    objectives only, as ``solve_batch`` returns them);
  - ``program32``: the program's own float32 path (``dtype="float32"``,
    which runs on its host loop, ``fused=False``) through the solo entry.

One JSON line per seed and kind: the numbers compared, each with its
limit, and ``correct``.  The benchmark's runs never run this; it needs
no card (``--device cpu`` runs it on the host).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from sdpbench import catalog, check, reference, traffic


def reference32(pool, fleet: bool, device) -> list:
    out = []
    for i, d in enumerate(pool.data):
        sol = reference.solve(reference.Problem(d, device, torch.float32))
        status = check.OPTIMAL if sol.status == "optimal" else "STALLED"
        out.append(check.Answer(i, status, sol.p_obj, sol.d_obj, sol.y,
                                None if fleet else sol.X))
    return out


def program32(pool, fleet: bool, device) -> list:
    from hdsdp_tpu_torch.io.sdpa import read_sdpa
    from hdsdp_tpu_torch.models.problem import SDPProblem
    from hdsdp_tpu_torch.solver.solver import HDSDPSolver

    out = []
    for i, path in enumerate(pool.paths):
        s = HDSDPSolver(SDPProblem.from_sdpa(read_sdpa(path)), device=device, verbose=False,
                        dtype="float32", fused=False)
        r = s.optimize()
        prim = None if fleet else s.get_primal()
        out.append(check.Answer(i, r.status, r.p_obj, r.d_obj, np.asarray(r.y, np.float64),
                                None if prim is None else np.asarray(prim[0][0], np.float64)))
    return out


KINDS = {"reference32": reference32, "program32": program32}


def control(workload: str, seed: int, kind: str, device="cuda", bench=None, dirs=()) -> dict:
    bench = catalog.load_benchmark() if bench is None else bench
    cell = catalog.cell(bench, workload)
    cfg = catalog.config(cell["config"], dirs)
    mix = catalog.traffic(cell["traffic"], dirs)
    gen = catalog.generator(cfg["generator"], dirs)
    with tempfile.TemporaryDirectory(prefix="sdpbench-control-") as tmp:
        pool = traffic.make_pool(gen, cfg["args"], seed, mix["pool"], tmp, mix["draw"])
        t0 = time.perf_counter()
        answers = KINDS[kind](pool, mix["fleet"] > 1, device)
        solve_s = time.perf_counter() - t0
    v = check.judge(pool.data, answers, cfg["check"]["limits"], seed, mix["sample"], device=device)
    return {"workload": workload, "seed": seed, "kind": kind, "correct": v["correct"],
            "answers": len(answers), "solve_s": solve_s, "reference_s": v["reference_s"],
            "numbers": {k: {"value": x, "limit": lim} for k, (x, lim) in v["numbers"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", default="reference32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        for kind in args.kinds.split(","):
            print(json.dumps(control(args.workload, seed, kind, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
