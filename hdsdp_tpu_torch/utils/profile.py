"""Tracing and profiling utilities (the JAX package's ``utils/profile.py``
in torch idiom).

  * ``span``, ``count``, ``recording``  the program's one tracer: spans at
                    its layer boundaries and counters at the sites where
                    the work happens (the reference's
                    HDSDP_CODE_PROFILER_START/END, ref
                    interface/hdsdp_utils.h:55-70), off unless a
                    ``recording()`` is open;
  * ``profile_fn``  repeat-and-time a callable (HDSDP_PROFILER), waiting
                    for the CUDA devices its outputs lie on;
  * ``trace``       a ``torch.profiler`` run written as a Chrome trace;
  * ``PhaseStats``  per-phase counters with the factor:solve time ratio
                    the LP solver uses as a policy input (ref
                    def_hdsdp_lpkkt.h:42-46, hdsdp_lpsolve.c:501-503).

The tracer never waits for the device and never reads it: a span is the
host's interval (``time.perf_counter_ns``), and each also opens a
``torch.profiler.record_function`` labelled ``hdsdp/<name>``, so that a
profiler's trace holds it on the kernels' clock, with its image on the
device's timeline.  Off (the default), ``span`` returns one shared no-op
context and ``count`` returns, after one check of a module global each.
Recording is for the thread that opened it.

``utils/stage_profile.py`` is the port's own per-stage tool for the SDP
solve and is separate from these.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

LABEL = "hdsdp/"  # the profiler's label of a span: LABEL + name

_NULL = contextlib.nullcontext()
_REC: Optional["Recording"] = None  # the recording in progress; None: off


@dataclass
class SpanRecord:
    """One closed span: host nanoseconds (``time.perf_counter_ns``), its id,
    the id of the span it ran in, and of the outermost span around it (a
    ``solve`` root's id is shared by every span under it)."""

    name: str
    t0: int
    t1: int
    id: int
    parent: Optional[int]
    root: int


@dataclass
class Recording:
    """What a ``recording()`` collected: closed spans, in the order they
    closed, and counters by name."""

    spans: List[SpanRecord] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    _open: list = field(default_factory=list, repr=False)
    _next_id: int = 0


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "root", "rf", "t0")

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        self.id = rec._next_id
        rec._next_id += 1
        outer = rec._open
        self.parent = outer[-1].id if outer else None
        self.root = outer[0].id if outer else self.id
        outer.append(self)
        self.rf = torch.profiler.record_function(LABEL + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        rec = self.rec
        rec._open.pop()
        rec.spans.append(SpanRecord(self.name, self.t0, t1, self.id, self.parent, self.root))
        return False


def span(name: str):
    """A context manager that records the block as a span ``name`` while a
    recording is open, and does nothing otherwise."""
    if _REC is None:
        return _NULL
    return _Span(_REC, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a recording is open."""
    if _REC is not None:
        _REC.counters[name] = _REC.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn the tracer on for the block; yields the ``Recording`` that
    holds its spans and counters (complete when the block ends)."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None


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
