"""What a run hands its metric readers.

Each metric is a module ``metrics/<name>.py`` with ``read(rec: Record)``,
which returns the metric's value or None where the run has nothing for it
to read, and ``SPANS``, the functions of the program (name -> target, see
``sdpbench.tracing``) that it needs wrapped in a traced run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from sdpbench import tracing
from sdpbench.traffic import Call


@dataclass
class Record:
    workload: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float  # host clock, from the first call's start to the last call's end
    calls: List[Call]
    peak_bytes: Optional[int]  # most device memory allocated in the window
    device_kind: str
    peaks: Optional[dict]  # the card's published peaks (peaks.json), None if unknown
    spans: List[tracing.Span] = field(default_factory=list)  # host spans, traced runs
    profile: Optional[tracing.Profile] = None  # the device trace, traced runs

    @property
    def solves(self) -> int:
        """Answers the window completed (each fleet member is one)."""
        return sum(len(c.answers) for c in self.calls)

    @property
    def iterations(self) -> int:
        return sum(c.iterations for c in self.calls)

    def span_s(self, *names: str) -> Optional[float]:
        """Host seconds inside spans of these names (their union), None if
        none ran."""
        iv = [(s.t0, s.t1) for s in self.spans if s.name in names]
        return tracing.union_length(iv) if iv else None

    def window_ns(self) -> Optional[Tuple[int, int]]:
        """The window on the profiler's clock."""
        if self.profile is None:
            return None
        w = [(s, e) for name, s, e in self.profile.spans if name == "window"]
        return w[0] if w else None

    def in_window(self, events):
        lo_hi = self.window_ns()
        if lo_hi is None:
            return []
        lo, hi = lo_hi
        return [(n, max(s, lo), min(e, hi)) for n, s, e in events if e > lo and s < hi]

    def busy_s(self) -> Optional[float]:
        """Seconds in which some operation ran on the device in the window."""
        ops = self.in_window(self.profile.ops) if self.profile else []
        return tracing.union_length([(s, e) for _, s, e in ops]) * 1e-9 if ops else None

    def traced_window_s(self) -> Optional[float]:
        lo_hi = self.window_ns()
        return (lo_hi[1] - lo_hi[0]) * 1e-9 if lo_hi else None
