"""Spans and the device trace of a traced run.

A span wraps a function of the program from the outside, by module
attribute (``"package.module:function"`` or ``"package.module:Class.method"``),
as ``hdsdp_tpu_torch/utils/stage_profile.py`` does: every call records its
host interval and the shapes of its tensor arguments, under a
``torch.profiler.record_function`` label ``sdpbench/<name>``.  The device is
synchronised at both ends of a span, so a span's interval holds the device
work of the kernels it launched.  Spans nest and do not add up to the wall.
Callers reach the wrapped function through the module attribute (the
program's modules call each other so), which is why wrapping works.

``read_profile`` reduces a ``torch.profiler`` session to the device
operations, the kernels, and the spans as the profiler saw them, all on the
profiler's clock; ``union_length`` and ``idle_gaps`` are the interval
arithmetic the device metrics use.
"""

from __future__ import annotations

import importlib
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

LABEL = "sdpbench/"


@dataclass
class Span:
    name: str
    t0: float  # host seconds (perf_counter)
    t1: float
    shapes: Tuple[tuple, ...] = ()


def resolve(target: str):
    """(owner, attribute) of ``"module:attr.path"``."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Tracer:
    """Collects spans.  ``sync`` waits for the device (a no-op on the host)."""

    def __init__(self, sync: Callable[[], None], enabled: bool = True):
        self.sync = sync
        self.enabled = enabled
        self.spans: List[Span] = []
        self._saved = []

    @contextmanager
    def span(self, name: str, shapes: Tuple[tuple, ...] = ()):
        if not self.enabled:
            yield
            return
        import torch

        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(LABEL + name):
            try:
                yield
            finally:
                self.sync()
                self.spans.append(Span(name, t0, time.perf_counter(), shapes))

    def wrap(self, targets: Dict[str, str]) -> None:
        """Wrap every ``name -> target`` function."""
        if not self.enabled:
            return
        import torch

        for name, target in targets.items():
            owner, attr = resolve(target)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
                with self.span(_name, shapes):
                    return _fn(*args, **kwargs)

            setattr(owner, attr, wrapped)

    def unwrap(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit (the
    arithmetic of ``utils/stage_profile._union_length``)."""
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


def idle_gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The gaps in [lo, hi] that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def innermost(spans, points) -> List[Optional[str]]:
    """For each sorted point, the name of the innermost span holding it
    (spans nest: each is (name, start, end) on one thread)."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, k = [], [], 0
    for p in points:
        while k < len(spans) and spans[k][1] <= p:
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        # a span that ended before p may sit under one that is still open
        live = [s for s in stack if s[2] >= p]
        stack = live
        out.append(live[-1][0] if live else None)
    return out


@dataclass
class Profile:
    """A profiler session on its own clock (integer nanoseconds)."""

    ops: List[Tuple[str, float, float]] = field(default_factory=list)  # every device op
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # no copies/memsets
    spans: List[Tuple[str, float, float]] = field(default_factory=list)  # sdpbench/ labels


def short_name(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].strip()


def read_profile(prof) -> Profile:
    """The device operations and the benchmark's spans of a finished
    ``torch.profiler.profile`` (read from the raw events: building
    ``prof.events()`` takes minutes at these counts)."""
    from torch.autograd import DeviceType

    out = Profile()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith(LABEL):  # a span's image on the device's timeline
                continue
            out.ops.append((name, s, e))
            if not name.startswith(("Memcpy", "Memset")):
                out.kernels.append((name, s, e))
        elif name.startswith(LABEL):
            out.spans.append((name[len(LABEL):], s, e))
    return out
