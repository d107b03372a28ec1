"""check_ms_per_solve: host ms per solve in the check layer: the DIMACS check
(``solver/dimacs.py`` ``check_solution``) and the primal recovery that
``HDSDPSolver.get_primal`` runs for the user (the traffic loop's own span),
device-synced at both ends."""

SPANS = {"dimacs": "hdsdp_tpu_torch.solver.dimacs:check_solution"}


def read(rec):
    t = rec.span_s("dimacs", "get_primal")
    return 1e3 * t / rec.solves if t is not None and rec.solves else None
