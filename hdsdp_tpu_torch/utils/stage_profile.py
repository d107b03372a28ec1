"""Where a solve's time goes, stage by stage, on one CUDA card.

    python -m hdsdp_tpu_torch.utils.stage_profile [NAME] [--fused false] [--out FILE]

NAME is one of the instances of ``utils.instances`` (default ``gpp500``;
also ``maxG51``, ``torusg3-15``, ``theta6``, ``maxG55``, ``control11``,
``theta-m25001``), solved through ``solve_sdpa_file`` with that instance's
overrides on the default path (the fused phase bodies below their memory
budget, ``Result.stats["fused"]`` says which mode ran), or with
``--fused false`` on the host loop: once to warm up, then five times
(gpp500), twice (theta-m25001) or three times (the others) with host
timers around the stages (for the host loop: ``ConeSystem`` methods, the
M factor and solves of ``DualIPM``, the operator KKT build; for the fused
bodies: the functions of ``solver.fused`` of the same names; both: the
PSDP refiner and the DIMACS check), then once with CUDA events around the
parts of the KKT build, then once more under ``torch.profiler`` to count
what ran on the device.  On the default path it also profiles one
host-loop solve of the same instance, so that one call gives both
loops' counts per iteration.  It reports:

  - the wall time of every timed solve (host clock, ending in a device
    sync) and, for the median solve, each stage's calls, host milliseconds
    and share of the wall; what no timer covers is the host loop itself;
    the solve's peak device memory and its factor statistics (with
    AdaptiveCG's call ledger where it ran, and PSDP's iterations);
  - for the same solve, the parts of operator mode wherever they run
    (inside the M solves, PSDP and the check): the CG ladder
    ``_op_solve``, every PCG run, the preconditioner build
    ``_build_chunked_precond`` and, inside it, the row chunks and the f32
    factor with its inverse.  These timers synchronize the device at both
    ends, so each part owns the device time of its kernels; they nest in
    the stages above and in one another and do not add up to the wall;
  - from the event-timed solve: the device milliseconds between the start
    and the end of every ``chol_inverse``, ``group_schur`` and
    ``group_dual`` call (idle gaps of the device inside a call included),
    and the most device memory one call held beyond what was allocated
    when it began (its temporaries and its result);
  - from the profiled solve: the number of device kernels (every profiler
    event on the device that is not a memory copy or memset) in total and
    per iteration, the device-to-host copies (the host's reads), the
    device's busy time as the union of the kernels' intervals, and the
    kernels that took most device time, by name;
  - the launches of the port's own CUDA kernels (their wrappers' counters);
  - per iteration of the profiled solve: wall ms, device kernels, host
    reads, and (fused) the fused module's own decision reads
    (``Result.stats["fused_host_reads"]``), for the path run and, on the
    default path, for the host loop too.

The result is printed as one JSON object, and written to ``--out`` when
that is given.  A stage's host time includes waiting
for the device wherever the stage reads a value back.  It needs a card:
without one it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

STAGES = {  # report name -> (owner, method)
    "assemble": ("cones", "assemble"),
    "psd_factor": ("cones", "factor"),
    "logdet": ("cones", "logdet"),
    "build_kkt": ("cones", "build_kkt"),
    "interior_check": ("cones", "interior_check"),
    "ratio_test": ("cones", "ratio_test"),
    "add_step_check": ("cones", "add_step_check"),
    "op_kkt_build": ("ipm", "_build_kkt_operator"),
    "m_factor": ("ipm", "factor_kkt"),
    "m_solve": ("ipm", "solve_kkt"),
    "m_solve_multi": ("ipm", "solve_kkt_multi"),
    "psdp": ("psdp", "optimize"),
    "dimacs_check": ("dimacs", "check_solution"),
}

# the same stages of the fused bodies (solver.fused functions)
FUSED_STAGES = {
    "build_kkt": ("fused", "build_kkt"),
    "m_factor": ("fused", "factor_m"),
    "m_solve": ("fused", "solve_m"),
    "ratio_test": ("fused", "cone_ratio"),
    "interior_check": ("fused", "check_interior"),
    "add_step_check": ("fused", "add_step_to_checker"),
    "prox_measure": ("fused", "prox_measure"),
    "psdp": STAGES["psdp"],
    "dimacs_check": STAGES["dimacs_check"],
}

# operator mode's parts, timed wherever they run (nested, device-synced)
OP_PARTS = {
    "op_solve": ("ipm", "_op_solve"),
    "kkt_pcg": ("cones", "kkt_pcg"),
    "kkt_pcg_chol": ("cones", "kkt_pcg_chol"),
    "op_precond_build": ("ipm", "_build_chunked_precond"),
    "kkt_rows": ("cones", "kkt_rows"),
    "factor_scaled_f32": ("algo", "factor_scaled_f32"),
}

# parts of the KKT build (and the dual assembly) timed with CUDA events
PARTS = {"chol_inverse": ("chol", "chol_inverse"), "group_schur": ("schur", "group_schur"),
         "group_dual": ("schur", "group_dual")}


def _install_timers(owners, acc, stages=STAGES):
    """Wrap each stage so that its host time and calls add up in acc;
    nested stages (the DIMACS check re-enters the cone system) count in
    the outermost one only.  Returns a function that undoes the wrapping."""
    depth = [0]
    saved = []
    for stage, (owner, method) in stages.items():
        target = owners[owner]
        fn = getattr(target, method)
        saved.append((target, method, fn))

        def timed(*args, _fn=fn, _stage=stage, **kwargs):
            if depth[0]:
                return _fn(*args, **kwargs)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                acc[_stage][0] += 1
                acc[_stage][1] += time.perf_counter() - t0
                depth[0] -= 1

        setattr(target, method, timed)

    def undo():
        for target, method, fn in saved:
            setattr(target, method, fn)

    return undo


def _install_synced_timers(owners, acc, torch):
    """Wrap each part of operator mode so that its calls and its time
    between two device syncs add up in acc, nested or not.  Returns the
    undo."""
    saved = []
    for part, (owner, name) in OP_PARTS.items():
        target = owners[owner]
        fn = getattr(target, name)
        saved.append((target, name, fn))

        def timed(*args, _fn=fn, _part=part, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                acc[_part][0] += 1
                acc[_part][1] += time.perf_counter() - t0

        setattr(target, name, timed)

    def undo():
        for target, name, fn in saved:
            setattr(target, name, fn)

    return undo


def _install_events(modules, records, torch):
    """Wrap each part so that every call records a pair of CUDA events and
    the device memory it held beyond its start.  Returns the undo."""
    saved = []
    for part, (owner, name) in PARTS.items():
        target = modules[owner]
        fn = getattr(target, name)
        saved.append((target, name, fn))

        def timed(*args, _fn=fn, _part=part, **kwargs):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(*args, **kwargs)
            end.record()
            rec = records[_part]
            rec["events"].append((start, end))
            rec["peak_extra_bytes"] = max(rec["peak_extra_bytes"],
                                          torch.cuda.max_memory_allocated() - base)
            return out

        setattr(target, name, timed)

    def undo():
        for target, name, fn in saved:
            setattr(target, name, fn)

    return undo


def _union_length(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profiled_solve(solve):
    """Run ``solve()`` (returning (Result, wall s)) once under
    ``torch.profiler``; returns (Result, wall, counts) where counts holds
    the device kernels (every device event that is not a memory copy or
    memset), the device-to-host copies (the host's reads), the device's
    busy ms (the union of the kernels' intervals), the kernels that took
    most device time, and each per iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r, wall = solve()
    kernels, copies_d2h, by_name = [], 0, defaultdict(lambda: [0, 0.0])
    # the raw events: building prof.events() takes about a minute a solve
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name = ev.name()
        if name.startswith(("Memcpy", "Memset")):
            copies_d2h += "DtoH" in name
            continue
        start, dur = ev.start_ns() / 1e3, ev.duration_ns() / 1e3  # us
        kernels.append((start, start + dur))
        short = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
        by_name[short][0] += 1
        by_name[short][1] += dur / 1e3
    busy = _union_length(kernels) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    n = max(r.n_iters, 1)
    return r, wall, {
        "wall_s": wall,
        "iterations": r.n_iters,
        "fused": r.stats.get("fused"),
        "device_kernels": len(kernels),
        "device_to_host_copies": copies_d2h,
        "device_busy_ms": busy,
        "device_busy_share_of_profiled_wall": busy / (1e3 * wall),
        "top_kernels_ms": {k: {"calls": c, "ms": t} for k, (c, t) in top},
        "per_iteration": {
            "wall_ms": 1e3 * wall / n,
            "device_kernels": len(kernels) / n,
            "host_reads": copies_d2h / n,
            "fused_decision_reads": r.stats.get("fused_host_reads", 0) / n,
        },
    }


def main(argv=None) -> int:
    from hdsdp_tpu_torch.utils.instances import INSTANCES, write_instance

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", nargs="?", default="gpp500", choices=sorted(INSTANCES))
    ap.add_argument("--fused", choices=("auto", "false"), default="auto",
                    help="the IPM mode: the default choice, or the host loop")
    ap.add_argument("--out", default=None, help="also write the JSON to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("stage_profile: needs a CUDA card", file=sys.stderr)
        return 1

    from hdsdp_tpu_torch.ops import chol, hpmm, schur
    from hdsdp_tpu_torch.solver import algo, dimacs, fused
    from hdsdp_tpu_torch.solver.algo import DualIPM
    from hdsdp_tpu_torch.solver.cones import ConeSystem
    from hdsdp_tpu_torch.solver.psdp import PSDPRefiner
    from hdsdp_tpu_torch.solver.solver import solve_sdpa_file

    owners = {"cones": ConeSystem, "ipm": DualIPM, "dimacs": dimacs, "psdp": PSDPRefiner,
              "algo": algo, "fused": fused}
    reps = {"gpp500": 5, "theta-m25001": 2}.get(args.name, 3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, args.name + ".dat-s")
        overrides = write_instance(args.name, path)
        if args.fused == "false":
            overrides["fused"] = False

        def solve(**over):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = solve_sdpa_file(path, device="cuda", verbose=False, **dict(overrides, **over))
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        r, first_wall = solve()  # builds the kernels, starts the libraries
        stages_of = FUSED_STAGES if r.stats.get("fused") else STAGES
        runs = []
        for _ in range(reps):
            acc = defaultdict(lambda: [0, 0.0])
            op_acc = defaultdict(lambda: [0, 0.0])
            undo_op = _install_synced_timers(owners, op_acc, torch)  # innermost wrappers
            undo = _install_timers(owners, acc, stages_of)
            try:
                r, wall = solve()
            finally:
                undo()
                undo_op()
            runs.append((wall, {k: list(v) for k, v in acc.items()},
                         torch.cuda.max_memory_allocated(),
                         {k: list(v) for k, v in op_acc.items()}))
        records = {p: {"events": [], "peak_extra_bytes": 0} for p in PARTS}
        undo = _install_events({"chol": chol, "schur": schur}, records, torch)
        try:
            r, event_wall = solve()
        finally:
            undo()
        parts = {
            p: {"calls": len(rec["events"]),
                "device_ms": sum(s.elapsed_time(e) for s, e in rec["events"]),
                "peak_extra_bytes": rec["peak_extra_bytes"]}
            for p, rec in records.items()
        }
        hpmm.KERNEL_LAUNCHES = hpmm.SLICE_LAUNCHES = 0
        r, prof_wall, counts = profiled_solve(solve)
        own = {"hpmm_pairs": hpmm.KERNEL_LAUNCHES, "hpmm_slice": hpmm.SLICE_LAUNCHES}
        host_loop = None
        if r.stats.get("fused"):
            solve(fused=False)  # warm-up of the host loop's own calls
            host_loop = profiled_solve(lambda: solve(fused=False))[2]

    walls = [w for w, _, _, _ in runs]
    med_wall, med_acc, med_peak, med_op = sorted(runs, key=lambda x: x[0])[len(runs) // 2]
    stages = {
        s: {"calls": c, "host_ms": 1e3 * t, "share": t / med_wall}
        for s, (c, t) in sorted(med_acc.items(), key=lambda kv: -kv[1][1])
    }
    covered = sum(t for _, t in med_acc.values())
    stages["host_loop_rest"] = {"calls": None, "host_ms": 1e3 * (med_wall - covered),
                                "share": (med_wall - covered) / med_wall}

    operator_parts = {
        s: {"calls": c, "synced_ms": 1e3 * t, "share": t / med_wall}
        for s, (c, t) in sorted(med_op.items(), key=lambda kv: -kv[1][1])
    }

    gen, kw, _ = INSTANCES[args.name]
    counts["device_busy_share_of_median_wall"] = (
        counts["device_busy_ms"] / (1e3 * statistics.median(walls)))
    counts["own_kernel_launches"] = own
    out = {
        "card": card,
        "torch": torch.__version__,
        "instance": f"{args.name}: {gen}({', '.join(f'{k}={v}' for k, v in kw.items())})"
                    + "".join(f", {k}={v}" for k, v in overrides.items()),
        "m": int(r.y.shape[0]),
        "fused": r.stats.get("fused"),
        "status": r.status, "iters": r.n_iters, "d_obj": r.d_obj,
        "dimacs_max": float(abs(r.dimacs).max()),
        "factor_stats": r.stats,
        "first_solve_wall_s": first_wall,
        "warm_walls_s": walls,
        "warm_wall_median_s": statistics.median(walls),
        "peak_device_bytes_of_median_solve": med_peak,
        "stages_of_median_solve": stages,
        "operator_parts_of_median_solve": operator_parts,
        "event_timed_solve": {"wall_s": event_wall, "parts": parts},
        "profiled_solve": counts,
        "profiled_host_loop_solve": host_loop,
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
