"""iters_per_solve: IPM iterations per call: solo, the IPM's
(``Result.n_iters``, PSDP's included); in a fleet, the fleet's iterations
per ``solve_batch`` call (``stats["fleet"]["iterations"]``, plus those of a
member that left the fleet and was solved alone)."""

SPANS = {}


def read(rec):
    return rec.iterations / len(rec.calls) if rec.calls else None
