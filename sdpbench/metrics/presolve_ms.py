"""presolve_ms: host ms per solve in the entry layer: reading the SDPA file
(``read_sdpa``), the presolve and bucketing (``SDPProblem.from_sdpa``) and,
solo, ``HDSDPSolver(...)``; per member in a fleet.  The span is the traffic
loop's own (``sdpbench.traffic``)."""

SPANS = {}


def read(rec):
    t = rec.span_s("presolve")
    return 1e3 * t / rec.solves if t is not None and rec.solves else None
