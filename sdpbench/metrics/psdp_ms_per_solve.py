"""psdp_ms_per_solve: host ms per solve in the primal refinement
(``solver/psdp.py`` ``PSDPRefiner.optimize``), device-synced at both ends.
Nothing to read where no refinement ran."""

SPANS = {"psdp": "hdsdp_tpu_torch.solver.psdp:PSDPRefiner.optimize"}


def read(rec):
    t = rec.span_s("psdp")
    return 1e3 * t / rec.solves if t is not None and rec.solves else None
