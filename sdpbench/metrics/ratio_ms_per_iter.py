"""ratio_ms_per_iter: host ms per IPM iteration inside the fused ratio
test (``solver/fused.py`` ``cone_ratio``: the f32 Lanczos or the exact
eigenvalue test of ``ops/ratio.py``), device-synced at both ends."""

SPANS = {"ratio_test": "hdsdp_tpu_torch.solver.fused:cone_ratio"}


def read(rec):
    t = rec.span_s("ratio_test")
    return 1e3 * t / rec.iterations if t is not None and rec.iterations else None
