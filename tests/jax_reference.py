"""The JAX package's answer for a named instance of the port's card-side
scripts: where the reference objectives and iteration counts in
``chip_smoke.py`` come from.

    JAX_PLATFORMS=cpu python tests/jax_reference.py theta-m25001
    JAX_PLATFORMS=cpu python tests/jax_reference.py maxG51 --fused auto

Solves the instance's generator call (``hdsdp_tpu_torch/utils/instances.py``)
with ``hdsdp_tpu``'s ``HDSDPSolver(prob, fused=...)`` and the instance's
overrides, on the CPU, and prints one JSON line.  ``--fused`` defaults to
``false``, the host loop (``FAMILY_REFS``, ``OPERATOR_JAX_REF``);
``--fused auto`` takes the JAX package's default mode, the fused
programs below its memory budget (``FUSED_REFS``).  The largest instance
(theta-m25001, operator mode) holds about 19 GB and takes a quarter of an
hour on 8 cores.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hdsdp_tpu.models import synthetic  # noqa: E402
from hdsdp_tpu.models.problem import SDPProblem  # noqa: E402
from hdsdp_tpu.solver.solver import HDSDPSolver  # noqa: E402
from hdsdp_tpu_torch.utils.instances import INSTANCES  # noqa: E402

FUSED = {"false": False, "auto": "auto", "phase": "phase", "iter": "iter"}


def main(name: str, fused) -> int:
    gen, kwargs, overrides = INSTANCES[name]
    t0 = time.time()
    prob = SDPProblem.from_sdpa(getattr(synthetic, gen)(**kwargs))
    solver = HDSDPSolver(prob, fused=fused, verbose=False, **overrides)
    r = solver.optimize()
    print(json.dumps({
        "instance": name, "generator": gen, "kwargs": kwargs, "overrides": overrides,
        "fused": fused, "status": r.status, "iterations": r.n_iters, "d_obj": r.d_obj,
        "p_obj": r.p_obj, "dimacs_max": float(abs(r.dimacs).max()),
        "psdp_ended_the_solve": solver.ipm.psdp is not None,
        "stats": {k: v for k, v in r.stats.items() if isinstance(v, (int, float))},
        "cpu_wall_s": time.time() - t0,
    }))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", choices=sorted(INSTANCES))
    ap.add_argument("--fused", choices=sorted(FUSED), default="false")
    args = ap.parse_args()
    sys.exit(main(args.name, FUSED[args.fused]))
