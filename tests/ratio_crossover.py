"""The forms of the fixed-depth Lanczos ratio test, timed on the card: its
operator by two triangular solves a matvec (the reference's form) or by
products with an explicit L^{-1} (``hdsdp_tpu_torch/ops/ratio.py``
``_operator``), and its loop launched op by op in fresh buffers
or replaying one captured CUDA graph a step over static buffers (the port's
path on CUDA; ``_static_basis``).

    python tests/ratio_crossover.py [--sizes 192,300,512] [--fleet 1000x8]
                                    [--probe maxG51,theta6] [--out crossover.json]

For each order n (a single block, and each ``NxF`` fleet of F blocks of
order N) it runs one fixed-depth test as the fused driver's ``cone_ratio``
runs it (``block_ratio`` with 16 steps, a warm start, ``nan_safe``) in
three forms: ``trsv`` (triangular solves, eager loop), ``inverse`` (L^{-1},
eager loop) and ``graph`` (L^{-1}, step graphs).  Per test and form it
prints: the first test's wall time (the graph form's holds its capture)
and the memory still allocated and reserved after it (the graph form's
static buffers; its first capture of the process also reserves the
graphs' pool),
the host's wall time over a run of tests ending in a
synchronisation, the device time (the sum of the kernels' times in a
``torch.profiler`` trace), the stream time between two CUDA events around a
run of tests, the kernels launched, the peak of the memory allocated during
it, and the steps' distance from each other and from the f64 exact step
(the graph form must give the eager form's bits).  It also times, by CUDA
events, the forming of L^{-1} alone and the 18 matrix-vector products of a
test alone.  ``--probe`` solves the named instances of
``utils/instances.py`` once to warm, then under a ``profile.recording()``,
and prints ``ratio_inverse``, ``ratio_graph_captures`` and
``ratio_graph_replays`` beside ``ratio_tests``.  It exits 1 without a card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hdsdp_tpu_torch.ops import ratio  # noqa: E402
from hdsdp_tpu_torch.utils import profile  # noqa: E402

REPS = 20
INVERSE = ratio._operator
BASIS = ratio._basis


def _trsv_operator(L, dS, dt):
    """x -> L^{-1} (-dS) L^{-T} x by two triangular solves."""
    L, dS = L.to(dt), dS.to(dt)

    def mv(x):
        u = torch.linalg.solve_triangular(L.mT, x[..., None], upper=True)
        return torch.linalg.solve_triangular(L, -(dS @ u), upper=False)[..., 0]

    return mv


# form -> (operator, how the loop runs its steps: ``ratio._basis``)
FORMS = {"trsv": (_trsv_operator, ratio._fresh_basis),
         "inverse": (INVERSE, ratio._fresh_basis), "graph": (INVERSE, ratio._static_basis)}


def _case(n: int, fleet: int, seed: int = 0):
    """An f64 factor of an SPD S (condition ~1e4), a symmetric direction
    and a warm vector, shaped as cone_ratio hands them: [F, 1, n, n] for
    a fleet, [1, n, n] alone."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = (fleet, 1) if fleet > 1 else (1,)
    Q = torch.randn(lead + (n, n), generator=g, device="cuda", dtype=torch.float64)
    S = Q @ Q.mT / n + 1e-4 * torch.eye(n, device="cuda", dtype=torch.float64)
    L = torch.linalg.cholesky(S)
    G = torch.randn(lead + (n, n), generator=g, device="cuda", dtype=torch.float64)
    dS = (G + G.mT) / n ** 0.5
    v0 = torch.randn(lead + (n,), generator=g, device="cuda", dtype=torch.float32)
    return L, dS, v0


def _test(L, dS, v0):
    return ratio.block_ratio(L, dS, krylov=16, v0=v0, return_warm=True, adaptive=False,
                             nan_safe=True)


def _events_ms(fn, reps: int) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _device(fn, reps: int):
    """(device ms, kernels) per call of fn, from a profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ns, kernels = 0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and not ev.name().startswith(profile.LABEL):
            ns += ev.duration_ns()
            kernels += not ev.name().startswith(("Memcpy", "Memset"))
    return ns / 1e6 / reps, kernels / reps


def measure(n: int, fleet: int) -> dict:
    L, dS, v0 = _case(n, fleet)
    exact = ratio.exact_ratio_test(L, dS)
    row = {"n": n, "fleet": fleet}
    steps = {}
    for form, (op, basis) in FORMS.items():
        ratio._operator, ratio._basis = op, (lambda v, b=basis: b)
        torch.cuda.synchronize()
        kept, kept_r = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        steps[form] = _test(L, dS, v0)  # the graph form captures here
        torch.cuda.synchronize()
        row[f"{form}_first_ms"] = (time.perf_counter() - t0) * 1e3
        row[f"{form}_kept_mb"] = (torch.cuda.memory_allocated() - kept) / 1e6
        row[f"{form}_kept_reserved_mb"] = (torch.cuda.memory_reserved() - kept_r) / 1e6
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _test(L, dS, v0)
        torch.cuda.synchronize()
        row[f"{form}_extra_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
        row[f"{form}_wall_ms"] = _wall_ms(lambda: _test(L, dS, v0), REPS)
        row[f"{form}_device_ms"], row[f"{form}_kernels"] = _device(lambda: _test(L, dS, v0), REPS)
        row[f"{form}_events_ms"] = _events_ms(lambda: _test(L, dS, v0), REPS)
    ratio._operator, ratio._basis = INVERSE, BASIS
    row["graph_same_bits"] = all(torch.equal(a, b) for a, b in zip(steps["graph"], steps["inverse"]))
    steps = {form: out[0] for form, out in steps.items()}
    dt = torch.float32
    row["inverse_ms"] = _events_ms(lambda: ratio._inverse(L, dt), REPS)
    mv = ratio._operator(L, dS, dt)
    x = v0.clone()
    row["gemv18_ms"] = _events_ms(lambda: [mv(x) for _ in range(18)], REPS)
    row["ratio"] = row["inverse_device_ms"] / row["trsv_device_ms"]
    row["graph_wall_over_inverse"] = row["graph_wall_ms"] / row["inverse_wall_ms"]
    row["step_rel_diff"] = float(((steps["inverse"] - steps["trsv"]).abs() / steps["trsv"]).max())
    row["inverse_over_exact_max"] = float((steps["inverse"] / exact).max())
    row["trsv_over_exact_max"] = float((steps["trsv"] / exact).max())
    return row


def probe(names):
    from hdsdp_tpu_torch.solver.solver import solve_sdpa_file
    from hdsdp_tpu_torch.utils.instances import write_instance

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            path = os.path.join(tmp, name + ".dat-s")
            kw = write_instance(name, path)
            solve_sdpa_file(path, **kw)  # warm
            with profile.recording() as rec:
                res = solve_sdpa_file(path, **kw)
            c = rec.counters
            out[name] = {"status": str(res.status), "iterations": res.n_iters,
                         "ratio_tests": c.get("ratio_tests", 0),
                         "ratio_inverse": c.get("ratio_inverse", 0),
                         "ratio_graph_captures": c.get("ratio_graph_captures", 0),
                         "ratio_graph_replays": c.get("ratio_graph_replays", 0),
                         "share": c.get("ratio_inverse", 0) / max(c.get("ratio_tests", 0), 1)}
            print(json.dumps({"probe": name, **out[name]}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="192,300,512,1000,5000")
    ap.add_argument("--fleet", default="1000x8", help="NxF fleets, comma-separated")
    ap.add_argument("--probe", default="", help="instances to solve under a recording")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ratio_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    shapes = [(int(n), 1) for n in args.sizes.split(",") if n]
    shapes += [tuple(int(v) for v in f.split("x")) for f in args.fleet.split(",") if f]
    rows = []
    for n, fleet in shapes:
        rows.append(measure(n, fleet))
        print(json.dumps(rows[-1]), flush=True)
    result = {"device": torch.cuda.get_device_name(0), "rows": rows,
              "probe": probe([p for p in args.probe.split(",") if p])}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
