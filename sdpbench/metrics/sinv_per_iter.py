"""sinv_per_iter: S^-1 computations (``ops/chol.py`` ``chol_inverse``
calls, each one the benchmark's ``sinv`` span) per IPM iteration: the
Schur builds', the DIMACS check's and ``get_primal``'s together."""

SPANS = {"sinv": "hdsdp_tpu_torch.ops.chol:chol_inverse"}


def read(rec):
    calls = sum(1 for s in rec.spans if s.name == "sinv")
    return calls / rec.iterations if calls and rec.iterations else None
