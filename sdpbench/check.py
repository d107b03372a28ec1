"""The comparison that decides ``correct``.

Every answer the window produced is judged against the instance it
answers, from the benchmark's own data, by the plain reference
(``sdpbench.reference``), once the window has closed:

  - ``bad_status``: answers that are missing or whose status is not
    PRIMAL_DUAL_OPTIMAL.  The configuration states this guarantee, so the
    limit is 0.
  - ``dimacs_max``: the largest DIMACS error of any answer, worked out
    again in float64 from the data and the answer: with X, the primal
    residual, X's and the slack's most negative eigenvalue and the duality
    gap; without X (a fleet), the slack's and the gap between the reported
    p_obj and b'y of the returned y.
  - ``obj_err``: for the answers to a sample of instances drawn from the
    seed, the largest relative distance of any objective the answer gives
    (reported p_obj and d_obj, b'y, and <C, X> where X is given) from the
    optimum that the reference's own float64 solve finds.

Each number is printed beside its limit; the limits are the
configuration's (``check.limits`` of its file).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from sdpbench import reference

OPTIMAL = "PRIMAL_DUAL_OPTIMAL"
# what a reading that is not a finite number is reported as (JSON has no inf)
WORST = float(np.finfo(np.float64).max)


@dataclass
class Answer:
    """What one solve returned: ``instance`` indexes the pool."""

    instance: int
    status: Optional[str]  # None: no answer came
    p_obj: float = float("nan")
    d_obj: float = float("nan")
    y: Optional[np.ndarray] = None
    X: Optional[np.ndarray] = None


def answer_dimacs(cert: reference.Certificate, ans: Answer) -> float:
    if cert.gap is not None:
        return max(cert.p_infeas, cert.x_neg, cert.s_neg, cert.gap)
    # the reported primal objective against b'y of the y returned with it
    gap = abs(ans.p_obj - cert.d_obj) / (1.0 + abs(ans.p_obj) + abs(cert.d_obj))
    return max(cert.s_neg, gap)


def answer_obj_err(cert: reference.Certificate, ans: Answer, opt: float) -> float:
    vals = [ans.p_obj, ans.d_obj, cert.d_obj] + ([cert.p_obj] if cert.p_obj is not None else [])
    return max(abs(v - opt) / (1.0 + abs(opt)) for v in vals)


def sample_instances(answers: List[Answer], seed: int, k: int) -> List[int]:
    """``k`` of the answered instances, drawn from the seed."""
    have = sorted({a.instance for a in answers if a.status is not None})
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 0x5EED]))
    return sorted(rng.choice(have, size=min(k, len(have)), replace=False).tolist())


def judge(pool, answers: List[Answer], limits: Dict[str, float], seed: int, sample: int,
          device="cpu") -> dict:
    """Judge ``answers`` against their instances (``pool[i]`` is the
    SDPData of instance i).  Returns {"correct", "failed", "numbers",
    "reference_s"}; ``numbers`` maps each name to (value, limit).  An
    answer that is missing counts in ``bad_status`` alone."""
    t0 = time.perf_counter()
    optima = {}
    probs = {}

    def prob(i):
        if i not in probs:
            probs[i] = reference.Problem(pool[i], device, torch.float64)
        return probs[i]

    for i in sample_instances(answers, seed, sample):
        if i not in optima:
            sol = reference.solve(prob(i))
            optima[i] = 0.5 * (sol.p_obj + sol.d_obj)
    bad = dimacs_max = obj_err = 0.0
    failed = 0
    for a in answers:
        ok = a.status == OPTIMAL
        bad += not ok
        if a.status is None:
            failed += 1
            continue
        d = e = WORST
        if a.y is not None and np.all(np.isfinite(a.y)) and (
                a.X is None or np.all(np.isfinite(a.X))):
            cert = reference.certificate(prob(a.instance), a.y, a.X)
            d = answer_dimacs(cert, a)
            e = answer_obj_err(cert, a, optima[a.instance]) if a.instance in optima else 0.0
        d = d if np.isfinite(d) else WORST
        e = e if np.isfinite(e) else WORST
        dimacs_max, obj_err = max(dimacs_max, d), max(obj_err, e)
        failed += not (ok and d <= limits["dimacs_max"] and e <= limits["obj_err"])
    numbers = {"bad_status": (bad, float(limits["bad_status"])),
               "dimacs_max": (dimacs_max, float(limits["dimacs_max"])),
               "obj_err": (obj_err, float(limits["obj_err"]))}
    correct = bool(answers) and all(v <= lim for v, lim in numbers.values())
    return {"correct": correct, "failed": failed, "numbers": numbers,
            "reference_s": time.perf_counter() - t0}
