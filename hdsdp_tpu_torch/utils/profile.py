"""Tracing and profiling utilities (the JAX package's ``utils/profile.py``
in torch idiom).

  * ``Region``      named wall-clock accumulators (the reference's
                    HDSDP_CODE_PROFILER_START/END, ref
                    interface/hdsdp_utils.h:55-70);
  * ``profile_fn``  repeat-and-time a callable (HDSDP_PROFILER), waiting
                    for the CUDA devices its outputs lie on;
  * ``trace``       a ``torch.profiler`` run written as a Chrome trace;
  * ``PhaseStats``  per-phase counters with the factor:solve time ratio
                    the LP solver uses as a policy input (ref
                    def_hdsdp_lpkkt.h:42-46, hdsdp_lpsolve.c:501-503).

``utils/stage_profile.py`` is the port's own per-stage tool for the SDP
solve and is separate from these.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch


class Region:
    """Named wall-clock accumulators."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> str:
        rows = sorted(self.total.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{k:30s} {v:10.3f}s  x{self.count[k]}" for k, v in rows)


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    return found


def synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out`` (a
    tensor or a nest of tuples, lists and dicts); CPU tensors are ready."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)


def profile_fn(fn: Callable, *args, n: int = 10, block: bool = True) -> float:
    """Repeat-and-time (ref HDSDP_PROFILER): seconds per call of
    ``fn(*args)`` over ``n`` calls after one warm-up call."""
    out = fn(*args)
    if block:
        synchronize(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    if block:
        synchronize(out)
    return (time.perf_counter() - t0) / n


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is usable) and write a Chrome trace ``trace_<pid>_<ns>.json``
    into ``log_dir``; the profile object is yielded."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class PhaseStats:
    """Per-phase counters; factor:solve ratio is a policy signal."""

    assemble_s: float = 0.0
    factor_s: float = 0.0
    solve_s: float = 0.0
    n_assemble: int = 0
    n_factor: int = 0
    n_solve: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def factor_solve_ratio(self) -> float:
        if self.solve_s <= 0:
            return float("inf")
        return self.factor_s / self.solve_s
