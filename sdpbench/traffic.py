"""The one loop behind every traffic mix: a closed loop of solve requests.

A traffic file (``traffic/<name>.json``) gives:

  - ``pool``: how many instances of the configuration are drawn and
    written as SDPA files; call k of the loop takes the next ``fleet`` of
    them, in order, round the pool;
  - ``draw``: ``"relabel"``: instance k is drawn from ``SeedSequence([0,
    k])``, the same in every run, and the run's seed relabels its vertices
    (``SeedSequence([seed, k])``), so that every seed solves the same
    problems, as isomorphic copies with other numbers; ``"fixed"``:
    instance k is drawn from ``SeedSequence([0, k])`` and the run's seed
    only orders the pool, so that every seed solves the same problems with
    the same numbers (for configurations whose iteration counts move with
    the rounding of a relabelled copy);
  - ``fleet``: instances per call.  1: one user's solve through the
    program's entry (read, presolve, ``HDSDPSolver.optimize``, then
    ``get_primal`` for X, which ``solve_sdpa_file`` does not return);
    more: ``solve_batch`` of that many, each read and presolved in the
    call;
  - ``sample``: how many of the answered instances the check solves with
    the plain reference for their optimum.

One client sends the next call when the last one has returned.  The
program is reached through its module attributes at call time.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from sdpbench.check import Answer
from sdpbench.sdpa import Block, SDPData, write_sdpa


def instance_seed(seed: int, k: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1), k])


@dataclass
class Pool:
    data: List[SDPData]
    paths: List[str]
    order: List[int]  # the loop's order of the instances


def relabel(d: SDPData, rng) -> SDPData:
    """``d`` with the vertices of every block permuted by ``rng``."""
    blocks = []
    for blk in d.blocks:
        perm = rng.permutation(blk.dim).astype(np.int32)
        r, c = perm[blk.row], perm[blk.col]
        blocks.append(Block(blk.dim, blk.con, np.maximum(r, c), np.minimum(r, c), blk.val))
    return SDPData(d.m, d.b, blocks)


def make_pool(gen, args: dict, seed: int, size: int, directory: str, draw: str) -> Pool:
    data, paths = [], []
    for k in range(size):
        if draw == "relabel":
            d = relabel(gen.generate(instance_seed(0, k), **args),
                        np.random.default_rng(instance_seed(seed, k)))
        elif draw == "fixed":
            d = gen.generate(instance_seed(0, k), **args)
        else:
            raise ValueError(f"unknown draw {draw!r}")
        path = os.path.join(directory, f"instance{k}.dat-s")
        write_sdpa(d, path)
        data.append(d)
        paths.append(path)
    order = list(range(size))
    if draw == "fixed":
        order = np.random.default_rng(instance_seed(seed, size)).permutation(size).tolist()
    return Pool(data, paths, order)


@dataclass
class Call:
    answers: List[Answer]
    iterations: int  # IPM iterations solo, fleet iterations in a fleet
    seconds: float = 0.0  # host time of the call


def solve_call(k: int, pool: Pool, traffic: dict, overrides: dict, device,
               tracer) -> Call:
    from hdsdp_tpu_torch.io import sdpa as sdpa_io
    from hdsdp_tpu_torch.models import problem
    from hdsdp_tpu_torch.solver import batch, solver

    size = traffic["fleet"]
    idx = [pool.order[(k * size + j) % len(pool.order)] for j in range(size)]
    if size == 1:
        with tracer.span("presolve"):
            s = solver.HDSDPSolver(problem.SDPProblem.from_sdpa(sdpa_io.read_sdpa(pool.paths[idx[0]])),
                                   device=device, **overrides)
        r = s.optimize()
        with tracer.span("get_primal"):
            prim = s.get_primal()
        X = prim[0][0] if prim is not None else None
        return Call([Answer(idx[0], r.status, r.p_obj, r.d_obj, r.y, X)], r.n_iters)
    with tracer.span("presolve"):
        probs = [problem.SDPProblem.from_sdpa(sdpa_io.read_sdpa(pool.paths[i])) for i in idx]
    rs = batch.solve_batch(probs, device=device, **overrides)
    answers = [Answer(i, None) for i in idx]
    iterations = 0
    for j, r in enumerate(rs[:size]):
        answers[j] = Answer(idx[j], r.status, r.p_obj, r.d_obj, r.y, None)
        if r.stats.get("batch_solo"):  # left the fleet: re-solved alone
            iterations += r.n_iters
    fleet = next((r.stats["fleet"] for r in rs if "fleet" in r.stats), None)
    return Call(answers, iterations + (fleet["iterations"] if fleet else 0))


def run_window(seconds: float, solve, start: int = 0) -> Tuple[List[Call], float]:
    """Calls ``solve(k)`` for k = start, start + 1, ... until ``seconds``
    have passed; the call in flight then is the last.  Returns the calls
    and the elapsed seconds."""
    import time

    calls = []
    t0 = time.perf_counter()
    k = start
    while True:
        t = time.perf_counter()
        calls.append(solve(k))
        calls[-1].seconds = time.perf_counter() - t
        k += 1
        if time.perf_counter() - t0 >= seconds:
            return calls, time.perf_counter() - t0
