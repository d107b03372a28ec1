"""The JAX package's answer for a named instance of the port's card-side
scripts: where the reference objectives and iteration counts in
``chip_smoke.py`` come from.

    JAX_PLATFORMS=cpu python tests/jax_reference.py theta-m25001

Solves the instance's generator call (``hdsdp_tpu_torch/utils/instances.py``)
with ``hdsdp_tpu``'s host loop, ``HDSDPSolver(prob, fused=False)`` and the
instance's overrides, on the CPU, and prints one JSON line.  The largest
instance (theta-m25001, operator mode) holds about 19 GB and takes a
quarter of an hour on 8 cores.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hdsdp_tpu.models import synthetic  # noqa: E402
from hdsdp_tpu.models.problem import SDPProblem  # noqa: E402
from hdsdp_tpu.solver.solver import HDSDPSolver  # noqa: E402
from hdsdp_tpu_torch.utils.instances import INSTANCES  # noqa: E402


def main(name: str) -> int:
    gen, kwargs, overrides = INSTANCES[name]
    t0 = time.time()
    prob = SDPProblem.from_sdpa(getattr(synthetic, gen)(**kwargs))
    r = HDSDPSolver(prob, fused=False, verbose=False, **overrides).optimize()
    print(json.dumps({
        "instance": name, "generator": gen, "kwargs": kwargs, "overrides": overrides,
        "status": r.status, "iterations": r.n_iters, "d_obj": r.d_obj, "p_obj": r.p_obj,
        "dimacs_max": float(abs(r.dimacs).max()),
        "stats": {k: v for k, v in r.stats.items() if isinstance(v, (int, float))},
        "cpu_wall_s": time.time() - t0,
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in INSTANCES:
        sys.exit(f"usage: jax_reference.py {{{', '.join(sorted(INSTANCES))}}}")
    sys.exit(main(sys.argv[1]))
