"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` does everything but look for the card, so that the tests can
drive a whole run on the host at a tiny size; ``sdpbench.run`` is the
command, which refuses to run without the cards a cell asks for.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

from sdpbench import catalog, check, roofline, tracing, traffic
from sdpbench.record import Record

# packages that no run may load: the JAX reference package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "hdsdp_tpu")

# spans that name the host's work in a traced run's idle gaps, beside those
# the cell's metrics ask for
BREAKDOWN_SPANS = {"check_interior": "hdsdp_tpu_torch.solver.fused:check_interior"}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def breakdown(rec: Record) -> Optional[dict]:
    """The device operations that took most time, by name, and the idle
    time of the device by the span the host was in."""
    if rec.profile is None or rec.window_ns() is None:
        return None
    ops = rec.in_window(rec.profile.ops)
    by_name = {}
    for name, s, e in ops:
        short = tracing.short_name(name)
        by_name[short] = by_name.get(short, 0.0) + (e - s) * 1e-9
    lo, hi = rec.window_ns()
    gaps = tracing.idle_gaps([(s, e) for _, s, e in ops], lo, hi)
    labels = tracing.innermost([sp for sp in rec.profile.spans if sp[0] != "window"],
                               [(s + e) / 2 for s, e in gaps])
    idle = {}
    for (s, e), lab in zip(gaps, labels):
        lab = lab or "other"
        idle[lab] = idle.get(lab, 0.0) + (e - s) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: Optional[dict] = None, dirs: Sequence[Path] = (),
             t_process: Optional[float] = None, log=sys.stderr) -> Optional[dict]:
    """Run ``workload`` once and return its result line (a dict), or None
    where the run may print none (a forbidden module was loaded)."""
    t_process = time.perf_counter() if t_process is None else t_process
    import torch

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    bench = catalog.load_benchmark() if bench is None else bench
    cell = catalog.cell(bench, workload)
    cfg = catalog.config(cell["config"], dirs)
    mix = catalog.traffic(cell["traffic"], dirs)
    entries = catalog.metrics_of(bench, workload, trace)
    readers = {m["name"]: catalog.metric(m["name"], dirs) for m in entries}
    gen = catalog.generator(cfg["generator"], dirs)
    overrides = dict(cfg.get("solver", {}), verbose=False)
    tracer = tracing.Tracer(sync, enabled=trace)

    with tempfile.TemporaryDirectory(prefix="sdpbench-") as tmp:
        pool = traffic.make_pool(gen, cfg["args"], seed, mix["pool"], tmp, mix["draw"])

        def solve(k):
            return traffic.solve_call(k, pool, mix, overrides, device, tracer)

        solve(0)  # warm-up: the cell's own shapes
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if trace:
            spans = dict(BREAKDOWN_SPANS)
            for r in readers.values():
                spans.update(r.SPANS)
            tracer.wrap(spans)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        setup_s = time.perf_counter() - t_process
        try:
            if trace:
                with tracer.span("window"):
                    calls, window_s = traffic.run_window(seconds, solve)
            else:
                calls, window_s = traffic.run_window(seconds, solve)
            sync()
            peak = torch.cuda.max_memory_allocated() if on_card else None
        finally:
            t_stop = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
            tracer.unwrap()
    found = forbidden_modules()
    if found:
        print(f"sdpbench: the run loaded {found}: no result", file=log)
        return None
    t_read = time.perf_counter()
    profile = tracing.read_profile(prof) if prof is not None else None
    del prof
    if profile is not None:
        print(f"sdpbench: profiler stop {t_read - t_stop:.1f} s, reading "
              f"{time.perf_counter() - t_read:.1f} s, {len(profile.kernels)} kernels", file=log)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    answers = [a for c in calls for a in c.answers]
    verdict = check.judge(pool.data, answers, cfg["check"]["limits"], seed, mix["sample"],
                          device=device)
    rec = Record(workload, cfg, mix, setup_s, window_s, calls, peak, kind,
                 roofline.peaks(kind), tracer.spans, profile)
    metrics = {}
    for m in entries:
        v = readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": peak or 0,
           "power_limit": power_limit() if on_card else None}
    result = {"correct": verdict["correct"], "attempted": len(answers),
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec.busy_s() or 0.0
        dev["window_s"] = rec.traced_window_s() or window_s
        bd = breakdown(rec)
        if bd is not None:
            result["breakdown"] = bd
    print(f"sdpbench: {workload} seed {seed}: {len(calls)} calls, {len(answers)} answers, "
          f"{rec.iterations} iterations in {window_s:.3f} s; reference {verdict['reference_s']:.3f} s",
          file=log)
    print("sdpbench: calls (s, iterations): "
          + " ".join(f"{c.seconds:.3f}/{c.iterations}" for c in calls), file=log)
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["numbers"].items()}
    if forbidden_modules():
        print(f"sdpbench: the run loaded {forbidden_modules()}: no result", file=log)
        return None
    for k, (v, lim) in verdict["numbers"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=log)
    return result
