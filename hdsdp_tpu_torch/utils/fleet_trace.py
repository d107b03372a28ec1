"""Where a fleet member's trajectory leaves its solo one, iteration by
iteration.

    python -m hdsdp_tpu_torch.utils.fleet_trace NAME [--fleet N] [--seeds S ...]
        [--kw JSON] [--device cuda|cpu] [--looped-cholesky] [--ops LIST]
        [--out FILE]

NAME is one of the instances of ``utils.instances`` (e.g. ``gpp500``,
``maxG51``); the fleet is its generator at seeds 0..N-1 (or ``--seeds``)
with that instance's overrides (``--kw '{"n": 40}'`` replaces generator
arguments, for a small run on the host).  Each instance is solved solo (the
default, fused path), then the whole fleet once through ``solve_batch``
with its solo re-solves left out, so that only the fleet's own bodies
run.  The log rows that the fused bodies write every iteration (primal
and dual objective, infeasibility, mu, step, proximity, in internal
units) are captured at the end of every phase, and each member's rows
are held against its solo rows: the first iteration where they differ at
all, the largest relative difference of each column there, and the dual
objective's relative difference at later iterations.

``--looped-cholesky`` factors a batch of matrices one matrix at a time
(``cholesky_ex`` per matrix), as a solo solve does, instead of with the
batched factor: where a member's trajectory then stays on its solo one,
the batched factor's rounding is what moved it.

``--ops fused.build_kkt,chol.psd_check,...`` (functions of
``solver.fused``, ``solver.cones``, ``ops.schur``, ``ops.chol``,
``ops.ratio``, ``ops.hpmm``) records what each listed function returns,
call by call, in the first member's solo solve and in the fleet, and
reports the first call whose outputs differ in that member (the fleet's
calls line up with the solo ones until the members first disagree on a
decision; run a fleet of one to follow them to the end).

The result is printed as one JSON object, and written to ``--out`` when
that is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

COLUMNS = ("p_obj", "d_obj", "p_infeas", "mu", "step", "prox")


def _looped_cholesky_ex(orig):
    def chol(A, *, upper=False, check_errors=False, out=None):
        if A.ndim <= 2 or A.shape[:-2].numel() <= 1:
            return orig(A, upper=upper, check_errors=check_errors)
        flat = A.reshape((-1,) + A.shape[-2:])
        parts = [orig(a, upper=upper, check_errors=check_errors) for a in flat]
        L = torch.stack([p[0] for p in parts]).reshape(A.shape)
        info = torch.stack([p[1] for p in parts]).reshape(A.shape[:-2])
        return L, info
    return chol


def _flat(x, fleet: bool):
    """The tensors of a function's result (member 0's part of a fleet's),
    each as (shape, digest of its bytes, its first 4096 entries)."""
    if isinstance(x, torch.Tensor):
        t = (x[0] if fleet and x.ndim else x).detach().to(torch.float64).cpu().numpy()
        return [(t.shape, hashlib.sha1(np.ascontiguousarray(t).tobytes()).hexdigest(),
                 t.reshape(-1)[:4096].copy())]
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v, fleet)]
    if dataclasses.is_dataclass(x):
        return [a for f in dataclasses.fields(x) if f.name != "log"
                for a in _flat(getattr(x, f.name), fleet)]
    return []


def _record_calls(names, calls, fleet_flag):
    """Wrap each module.function of ``names`` to append (name, outputs)."""
    from hdsdp_tpu_torch.ops import chol, hpmm, ratio, schur
    from hdsdp_tpu_torch.solver import cones, fused

    mods = {"fused": fused, "cones": cones, "schur": schur, "chol": chol, "ratio": ratio,
            "hpmm": hpmm}
    for name in names:
        mod, fn = name.split(".")
        orig = getattr(mods[mod], fn)

        def wrapped(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            if fleet_flag[0] is not None:  # inside a phase drive
                calls.append((_name, _flat(out, fleet_flag[0])))
            return out
        setattr(mods[mod], fn, wrapped)


def _first_call_diff(solo, fleet) -> dict:
    for i, ((na, a), (nb, b)) in enumerate(zip(solo, fleet)):
        if na != nb:
            return {"calls_equal": i, "calls_part_at": [na, nb]}
        for j, ((xs, xh, x), (ys, yh, y)) in enumerate(zip(a, b)):
            if xs != ys or xh != yh:
                d = (float(np.nanmax(np.abs(x - y), initial=0.0))
                     if xs == ys else None)
                return {"calls_equal": i, "first_differing_call": na, "output": j,
                        "shapes": [list(xs), list(ys)], "max_abs_diff_of_first_4096": d,
                        "calls_before": [s[0] for s in solo[max(0, i - 5):i]]}
    return {"calls_equal": min(len(solo), len(fleet)), "solo_calls": len(solo),
            "fleet_calls": len(fleet)}


def _rows(records):
    """One trajectory's log rows from its phase records (phase A, then B)."""
    rows, n = None, 0
    for log, n_iter in records:
        rows = log if rows is None else np.where(np.isnan(rows), log, rows)
        n = max(n, int(n_iter))
    return rows[:n]


def _compare(solo, fleet) -> dict:
    n = min(len(solo), len(fleet))
    a, b = solo[:n], fleet[:n]
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    diff_rows = np.nonzero(~same.all(axis=1))[0]
    out = {"solo_iterations": len(solo), "fleet_iterations": len(fleet),
           "bit_equal_rows": int(diff_rows[0]) if len(diff_rows) else n}
    if len(diff_rows):
        k = int(diff_rows[0])
        rel = np.abs(a[k] - b[k]) / np.maximum(np.abs(a[k]), 1e-300)
        out["first_differing_iteration"] = k + 1
        out["rel_diff_there"] = dict(zip(COLUMNS, rel.tolist()))
        later = [j for j in (k + 1, k + 2, k + 5, k + 10, k + 20, n - 1) if k < j < n]
        out["rel_d_obj_diff_later"] = {
            str(j + 1): float(abs(a[j, 1] - b[j, 1]) / max(abs(a[j, 1]), 1e-300))
            for j in sorted(set(later))}
    out["solo_last_rows"] = solo[-3:].tolist()
    out["fleet_last_rows"] = fleet[-3:].tolist()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name")
    ap.add_argument("--fleet", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="*", default=None)
    ap.add_argument("--kw", default="{}", help="generator arguments to replace, as JSON")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--looped-cholesky", action="store_true")
    ap.add_argument("--ops", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from hdsdp_tpu_torch.models import synthetic
    from hdsdp_tpu_torch.models.problem import SDPProblem
    from hdsdp_tpu_torch.solver import batch as batch_mod
    from hdsdp_tpu_torch.solver import fused
    from hdsdp_tpu_torch.solver.solver import HDSDPSolver
    from hdsdp_tpu_torch.utils.device import resolve_device
    from hdsdp_tpu_torch.utils.instances import INSTANCES

    dev = resolve_device(args.device)
    gen, kw, over = INSTANCES[args.name]
    kw = dict(kw, **json.loads(args.kw))
    seeds = args.seeds if args.seeds else list(range(args.fleet))
    probs = [SDPProblem.from_sdpa(getattr(synthetic, gen)(**dict(kw, seed=s))) for s in seeds]
    if args.looped_cholesky:
        torch.linalg.cholesky_ex = _looped_cholesky_ex(torch.linalg.cholesky_ex)

    records = []  # (fleet size or 0, phase B?, log rows, n_iter, status)
    calls, fleet_flag = [], [None]  # recorded calls; a drive's fleet flag
    drive = fused._drive

    def traced(c, body, st, max_iter, is_phase_b, test_first, deadline=None):
        fleet_flag[0] = bool(c.fleet)
        st = drive(c, body, st, max_iter, is_phase_b, test_first, deadline)
        fleet_flag[0] = None
        records.append((c.fleet, is_phase_b, st.log.detach().cpu().numpy(),
                        st.n_iter.cpu().numpy(), st.status.cpu().numpy()))
        return st

    fused._drive = traced
    if args.ops:
        _record_calls(args.ops.split(","), calls, fleet_flag)
    solos = []
    for i, prob in enumerate(probs):
        records.clear()
        r = HDSDPSolver(prob, device=dev, verbose=False, **over).optimize()
        solos.append((r, [(log, n) for _, _, log, n, _ in records],
                      [int(code) for _, _, _, _, code in records]))
        if i == 0:
            solo_calls, calls[:] = list(calls), []

    class NoSolo:
        def __init__(self, *a, **k):
            pass

        def optimize(self):
            return SimpleNamespace(stats={})

    records.clear()
    calls.clear()
    batch_mod.HDSDPSolver = NoSolo
    rs = batch_mod.solve_batch(probs, device=dev, verbose=False, **over)
    fleet_recs = [r for r in records if r[0]]
    # members in phase A: all live ones (every instance here); phase B:
    # those that left A dual feasible, in order
    per_member = [[] for _ in probs]
    codes = [[] for _ in probs]  # each phase's end code (fused.RUNNING, ...)
    for size, is_b, log, n_iter, status in fleet_recs:
        members = list(range(len(probs))) if not is_b else go_b
        for k, i in enumerate(members):
            per_member[i].append((log[k], n_iter[k]))
            codes[i].append(int(status[k]))
        if not is_b:
            go_b = [i for k, i in enumerate(members) if int(status[k]) == fused.DUAL_FEASIBLE]
    report = {"name": args.name, "generator": f"{gen}({kw}) at seeds {seeds}",
              "overrides": over, "device": str(dev),
              "card": torch.cuda.get_device_name(0) if dev.type == "cuda" else None,
              "looped_cholesky": args.looped_cholesky, "members": []}
    if args.ops:
        report["first_member_calls"] = _first_call_diff(solo_calls, calls)
    for i, ((solo, solo_recs, solo_codes), r) in enumerate(zip(solos, rs)):
        entry = {"seed": seeds[i], "solo_status": solo.status, "solo_d_obj": solo.d_obj,
                 "phase_codes_solo_fleet": [solo_codes, codes[i]],
                 "fleet_exit": r.stats.get("batch_exit"),
                 "fleet_status": getattr(r, "status", None)}
        entry.update(_compare(_rows(solo_recs), _rows(per_member[i])))
        report["members"].append(entry)
    text = json.dumps(report)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
