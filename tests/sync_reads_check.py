"""The port's ``host_reads`` counter against the syncs CUDA reports, site by
site, on the card.

    python tests/sync_reads_check.py [--out sync_reads.json]

After one warm solve of each shape, it solves maxG51 (``utils/instances.py``,
``optimize`` then ``get_primal``, the fused "iter" driver), a fleet of 8
maxG51-class graphs (``solve_batch``) and theta6 (PSDP, the check's
ladder), each under ``torch.cuda.set_sync_debug_mode("warn")`` and a
``utils.profile.recording()``.  Every sync warning is placed at its Python
line and so in its function; every ``count("host_reads", n)`` at its
caller's function.  A warning at one of the ``H2D`` lines is a copy from
the host's pageable memory to the card, which waits for the stream too but
reads nothing, and is not counted.  It prints, per solve, the totals and
every function where the rest and the count differ, with the lines that
warned; the whole table goes to ``--out``.  It exits 1 without a card, and
1 if a function differs.  ``tests/test_torch_profile.py`` runs the same
comparison on a small solve and fleet (``-m cuda``).
"""

import argparse
import ast
import collections
import json
import linecache
import os
import sys
import tempfile
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hdsdp_tpu_torch.io.sdpa import read_sdpa, write_sdpa  # noqa: E402
from hdsdp_tpu_torch.models.problem import SDPProblem  # noqa: E402
from hdsdp_tpu_torch.models.synthetic import maxcut_sdpa  # noqa: E402
from hdsdp_tpu_torch.solver.batch import solve_batch  # noqa: E402
from hdsdp_tpu_torch.solver.solver import HDSDPSolver  # noqa: E402
from hdsdp_tpu_torch.utils import profile  # noqa: E402
from hdsdp_tpu_torch.utils.instances import write_instance  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FUNCS = {}

# host-to-device copies on these paths (a part of each source line)
H2D = (
    "torch.tensor(vals, dtype=dtype).to(dev)",  # fused._scalars
    "torch.as_tensor(h, device=c.b.device)",  # fused._select's mask
    "torch.as_tensor(w, device=dev) for w in _lz_start",  # fused._state_from_ipm
    "torch.tensor(np.asarray(x), dtype=dt, device=device)",  # cones._tensor
    "torch.as_tensor(x, dtype=self.dtype, device=self.device)",  # algo.DualIPM._vec
    "torch.tensor(maker.mu, dtype=ipm.dtype, device=ipm.device)",  # dimacs._dimacs_errors
    "dtype=ipms[0].dtype).to(dev)",  # batch: reset_rd
    "return torch.as_tensor(a, device=dev)",  # schur.with_tables: put
)


def _function_at(path: str, line: int) -> str:
    """The innermost function of ``path`` whose body holds ``line``."""
    if path not in _FUNCS:
        spans = []
        try:
            tree = ast.parse(open(path).read())
        except (OSError, SyntaxError):
            tree = None
        for node in ast.walk(tree) if tree else ():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                spans.append((node.lineno, node.end_lineno, node.name))
        _FUNCS[path] = spans
    inside = [s for s in _FUNCS[path] if s[0] <= line <= s[1]]
    return min(inside, key=lambda s: s[1] - s[0])[2] if inside else "<module>"


def _short(path: str) -> str:
    return os.path.relpath(path, REPO) if path.startswith(REPO) else path


def measured(fn):
    """Run ``fn`` under the sync debug mode and a recording; returns
    (warnings by site, counts by site, sample warned lines by site)."""
    counted = collections.Counter()
    inner = profile.count

    def count(name, n=1):
        if name == "host_reads":
            f = sys._getframe(1)
            counted[(_short(f.f_code.co_filename), f.f_code.co_name)] += n
        inner(name, n)

    profile.count = count
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught, profile.recording() as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        profile.count = inner
    warned, h2d = collections.Counter(), collections.Counter()
    lines = collections.defaultdict(collections.Counter)
    for w in caught:
        if "synchroniz" not in str(w.message) or not w.filename.startswith(REPO):
            continue  # (set_sync_debug_mode's own switch back warns in torch)
        site = (_short(w.filename), _function_at(w.filename, w.lineno))
        src = linecache.getline(w.filename, w.lineno).strip()
        (h2d if any(h in src for h in H2D) else warned)[site] += 1
        lines[site][f"{w.lineno}: {src}"] += 1
    return warned, h2d, counted, lines, rec.counters.get("host_reads", 0)


def differences(warned, h2d, counted, lines, total):
    """The functions whose reads (warnings at no ``H2D`` line) and count
    differ, with their warned lines."""
    return [{"file": f, "function": fn, "reads": warned[(f, fn)], "counted": counted[(f, fn)],
             "lines": dict(lines[(f, fn)])}
            for f, fn in sorted(set(warned) | set(counted)) if warned[(f, fn)] != counted[(f, fn)]]


def report(name, warned, h2d, counted, lines, total):
    diff = differences(warned, h2d, counted, lines, total)
    print(f"[{name}] host_reads {total}, sync warnings {sum(warned.values())} reads and "
          f"{sum(h2d.values())} host-to-device copies, {len(diff)} functions differ", flush=True)
    for r in diff:
        print(f"  {r['file']}:{r['function']}: reads {r['reads']}, counted {r['counted']}; "
              f"{r['lines']}", flush=True)
    return {"host_reads": total, "reads": sum(warned.values()), "h2d": dict(
        (f"{f}:{fn}", n) for (f, fn), n in h2d.items()), "differ": diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_reads_check: needs a CUDA card", file=sys.stderr)
        return 1
    out = {"device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name in ("maxG51", "theta6"):
            paths[name] = os.path.join(tmp, f"{name}.dat-s")
            write_instance(name, paths[name])
        fleet = []
        for s in range(8):
            p = os.path.join(tmp, f"fleet{s}.dat-s")
            write_sdpa(maxcut_sdpa(n=1000, seed=100 + s), p)
            fleet.append(p)

        def solo(name):
            def run():
                s = HDSDPSolver(SDPProblem.from_sdpa(read_sdpa(paths[name])), device="cuda",
                                verbose=False)
                r = s.optimize()
                s.get_primal()
                print(f"  {name}: {r.status} {r.n_iters} iterations, "
                      f"fused_host_reads {r.stats['fused_host_reads']}", flush=True)
            return run

        def batch():
            rs = solve_batch([SDPProblem.from_sdpa(read_sdpa(p)) for p in fleet], device="cuda",
                             verbose=False)
            print(f"  fleet8: {[r.status for r in rs]}, {rs[0].stats['fleet']['iterations']} "
                  f"fleet iterations, fused_host_reads {rs[0].stats['fused_host_reads']}",
                  flush=True)

        for name, fn in (("maxG51", solo("maxG51")), ("maxG51.fleet8", batch),
                         ("theta6", solo("theta6"))):
            fn()  # warm
            out[name] = report(name, *measured(fn))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 1 if any(out[k]["differ"] for k in out if k != "device") else 0


if __name__ == "__main__":
    sys.exit(main())
