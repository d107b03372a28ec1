"""kkt_ms_per_iter: host ms per IPM iteration in the Schur system: the
build (``fused.build_kkt`` into ``ops/schur.py``), the factor
(``fused.factor_m``) and the solves (``fused.solve_m``, into ``ops/chol.py``
and ``ops/cg.py``), device-synced at both ends."""

SPANS = {"build_kkt": "hdsdp_tpu_torch.solver.fused:build_kkt",
         "factor_m": "hdsdp_tpu_torch.solver.fused:factor_m",
         "solve_m": "hdsdp_tpu_torch.solver.fused:solve_m"}


def read(rec):
    t = rec.span_s(*SPANS)
    return 1e3 * t / rec.iterations if t is not None and rec.iterations else None
