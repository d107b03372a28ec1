"""Where a float32 solve's DIMACS check comes out: the trajectory or the
check.  Solves a named instance (``hdsdp_tpu_torch/utils/instances.py``)
with ``dtype="float32"`` on the host loop and writes its end state (the
checkpoint format both packages share: y, Rd, perturb and both makers),
or loads such a state, written by either package on any device, into a
fresh ``DualIPM`` and runs this package's check on it.  Either way it
prints one JSON line per maker with what the check sees there:

- ``lam_rel``: the least eigenvalue of the maker's dual slack
  Sbar = C - A'y, as the check forms it (y and the sums in float32), over
  its largest |eigenvalue|, both taken in float64 on the host; the least
  over the cone blocks.  A float32 Cholesky factor of Sbar is decided by
  rounding once this nears n * 6e-8;
- ``lam_rel_f64``: the same of Sbar formed in float64 from the same data
  at the maker's y as the solve left it (the margin the maker has before
  the check rounds it), and ``f32_err``: ||Sbar - Sbar_f64||_2 over the
  same largest |eigenvalue| (what the float32 assembly moved), both on
  the block with the least ``lam_rel``;
- ``rung``: the first rung of the check's diagonal-shift ladder
  (0 = no shift, k = a shift of 1e-14 * 100^(k - 1) of the largest
  diagonal, as the check's ``_maker_kkt`` takes them) at which this
  package's cone factor accepts Sbar on this device, or null;
- ``errors``: the six DIMACS errors of that maker, or null where the check
  found no positive definite Sbar;

and one last line with the check's status and errors over both makers.

    python tests/f32_check_witness.py solve control11 --device cuda --out card.npz
    python tests/f32_check_witness.py check control11 cpu.npz --device cuda
    JAX_PLATFORMS=cpu python tests/f32_check_witness.py solve control11 --package jax --out jax.npz
    JAX_PLATFORMS=cpu python tests/f32_check_witness.py check control11 card.npz --package jax

``--package port`` (the default) imports only ``hdsdp_tpu_torch``, so the
script runs on a card without JAX; ``--package jax`` runs the JAX package
on the CPU.  A state keeps the dtypes its solve left (a float32 solve's y
may have widened to float64), and the loaded state is given them as they
are.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hdsdp_tpu_torch.utils.instances import INSTANCES  # noqa: E402


class _Port:
    def __init__(self, device):
        import torch

        from hdsdp_tpu_torch.models import synthetic
        from hdsdp_tpu_torch.models.problem import SDPProblem
        from hdsdp_tpu_torch.solver import algo, dimacs
        from hdsdp_tpu_torch.solver import cones as cone_ops
        from hdsdp_tpu_torch.solver.params import Params
        from hdsdp_tpu_torch.solver.solver import HDSDPSolver
        from hdsdp_tpu_torch.utils.device import resolve_device

        self.torch, self.algo, self.dimacs, self.cone_ops = torch, algo, dimacs, cone_ops
        self.synthetic, self.SDPProblem, self.Params = synthetic, SDPProblem, Params
        self.HDSDPSolver, self.device = HDSDPSolver, device
        self.resolve_device = resolve_device

    def solver(self, prob, over):
        return self.HDSDPSolver(prob, device=self.device, **over)

    def ipm(self, prob, over):
        return self.algo.DualIPM(prob, self.Params(**over), device=self.resolve_device(self.device))

    def arr(self, ipm, x):
        return self.torch.from_numpy(np.array(x)).to(ipm.device)

    def host(self, x):
        return x.detach().cpu().numpy()

    def sbar(self, ipm, y, wide=False):
        dt = self.torch.float64 if wide else ipm.dtype
        return ipm.cones.assemble(1.0, -1.0, y.to(dt), ipm.perturb)

    def factor_ok(self, S, s_lp):
        return bool(self.cone_ops.factor(S, s_lp)[0])

    def shifted(self, S, delta):
        return tuple(Sg + delta * self.torch.eye(Sg.shape[-1], dtype=Sg.dtype,
                                                 device=Sg.device) for Sg in S)

    def sync(self):
        if self.device.startswith("cuda"):
            self.torch.cuda.synchronize()


class _Jax:
    def __init__(self):
        import jax.numpy as jnp

        from hdsdp_tpu.models import synthetic
        from hdsdp_tpu.models.problem import SDPProblem
        from hdsdp_tpu.solver import algo, dimacs
        from hdsdp_tpu.solver.params import Params
        from hdsdp_tpu.solver.solver import HDSDPSolver

        self.jnp, self.algo, self.dimacs = jnp, algo, dimacs
        self.synthetic, self.SDPProblem, self.Params = synthetic, SDPProblem, Params
        self.HDSDPSolver, self.device = HDSDPSolver, "cpu"

    def solver(self, prob, over):
        return self.HDSDPSolver(prob, **over)

    def ipm(self, prob, over):
        return self.algo.DualIPM(prob, self.Params(**over))

    def arr(self, ipm, x):
        return self.jnp.asarray(np.array(x))

    def host(self, x):
        return np.asarray(x)

    def sbar(self, ipm, y, wide=False):
        dt = self.jnp.float64 if wide else ipm.dtype
        return ipm.cones.assemble(1.0, -1.0, self.jnp.asarray(y, dt), ipm.perturb)

    def factor_ok(self, S, s_lp):
        return bool(self.dimacs._factor(S, s_lp)[0])

    def shifted(self, S, delta):
        return tuple(Sg + delta * self.jnp.eye(Sg.shape[-1], dtype=Sg.dtype) for Sg in S)

    def sync(self):
        pass


def _problem(pk, name):
    gen, kwargs, over = INSTANCES[name]
    prob = pk.SDPProblem.from_sdpa(getattr(pk.synthetic, gen)(**kwargs))
    return prob, dict(over, fused=False, dtype="float32", verbose=False)


def _load(pk, ipm, path):
    """The saved end state into ``ipm``, each array in the dtype it was
    saved in."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    if int(d["m"]) != ipm.m:
        raise ValueError(f"{path} is for m = {int(d['m'])}, the instance has m = {ipm.m}")
    ipm.y = pk.arr(ipm, d["y"])
    ipm.tau = float(d["tau"])
    ipm.Rd = float(d["rd"])
    ipm.mu = float(d["mu"])
    ipm.perturb = float(d["perturb"])
    for kind in ("acc", "inacc"):
        if np.asarray(d[f"maker_{kind}_y"]).size:
            setattr(ipm, f"maker_{kind}", pk.algo.Maker(
                mu=float(d[f"maker_{kind}_mu"]), y=pk.arr(ipm, d[f"maker_{kind}_y"]),
                dy=pk.arr(ipm, d[f"maker_{kind}_dy"])))
    return d


def _probe(pk, ipm, tag):
    """One JSON line per maker (see the module docstring), then the
    check's verdict."""
    for kind in ("acc", "inacc"):
        maker = getattr(ipm, f"maker_{kind}")
        if maker.mu <= 0.0:
            print(json.dumps({"probe": tag, "maker": kind, "mu": maker.mu}), flush=True)
            continue
        S, s_lp = pk.sbar(ipm, maker.y)
        S64 = pk.sbar(ipm, maker.y, wide=True)[0]
        blocks = []  # (lam_rel, lam_rel_f64, f32_err) per block
        for Sg, Wg in zip(S, S64):
            for a, w in zip(np.asarray(pk.host(Sg), dtype=np.float64).reshape(-1, *Sg.shape[-2:]),
                            np.asarray(pk.host(Wg)).reshape(-1, *Wg.shape[-2:])):
                ev, ew = np.linalg.eigvalsh(a), np.linalg.eigvalsh(w)
                top = max(abs(ew[0]), abs(ew[-1]))
                blocks.append((float(ev[0] / top), float(ew[0] / top),
                               float(np.linalg.norm(a - w, 2) / top)))
        lam = min(blocks)
        scale = max(float(np.max(np.abs(np.diagonal(pk.host(Sg), axis1=-2, axis2=-1))))
                    for Sg in S)
        rung = None
        for k in range(6):
            St = S if k == 0 else pk.shifted(S, scale * 1e-14 * (10.0 ** (2 * (k - 1))))
            if pk.factor_ok(St, s_lp):
                rung = k
                break
        t0 = time.perf_counter()
        errs = pk.dimacs._dimacs_errors(ipm, maker)
        pk.sync()
        print(json.dumps({
            "probe": tag, "maker": kind, "mu": maker.mu, "y_dtype": str(maker.y.dtype),
            "sbar_dtype": str(S[0].dtype), "block_dims": [int(Sg.shape[-1]) for Sg in S],
            "lam_rel": lam[0], "lam_rel_f64": lam[1], "f32_err": lam[2], "rung": rung,
            "errors": None if errs is None else [float(e) for e in errs],
            "check_s": time.perf_counter() - t0,
        }), flush=True)
    errs = pk.dimacs.check_solution(ipm)
    print(json.dumps({"probe": tag, "status": ipm.status, "errors": [float(e) for e in errs],
                      "d_obj": getattr(ipm, "d_obj_val", None),
                      "p_obj": getattr(ipm, "p_obj_val", None)}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("solve", "check"))
    ap.add_argument("name", choices=sorted(INSTANCES))
    ap.add_argument("state", nargs="?", help="check: the .npz a solve wrote")
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--out", help="solve: where to write the end state")
    a = ap.parse_args()
    pk = _Port(a.device) if a.package == "port" else _Jax()
    prob, over = _problem(pk, a.name)
    where = f"{a.package}:{pk.device}"
    if a.what == "solve":
        t0 = time.perf_counter()
        s = pk.solver(prob, over)
        r = s.optimize(checkpoint_to=a.out)
        pk.sync()
        print(json.dumps({
            "solve": a.name, "on": where, "status": r.status, "iterations": r.n_iters,
            "d_obj": float(r.d_obj), "errors": [float(e) for e in np.asarray(r.dimacs)],
            "y_dtype": str(s.ipm.y.dtype), "wall_s": time.perf_counter() - t0,
        }), flush=True)
        ipm = s.ipm
        tag = f"{where} at its own end state"
    else:
        ipm = pk.ipm(prob, over)
        d = _load(pk, ipm, a.state)
        tag = f"{where} at {os.path.basename(a.state)} (y {d['y'].dtype})"
    _probe(pk, ipm, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
