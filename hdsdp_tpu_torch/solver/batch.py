"""Batched multi-instance solving: N same-shape SDPs through ONE set of
fused phase bodies.

Port of the JAX package's solver/batch.py.  Small-m instances are pure
latency: a solve of mcp100 size is a few thousand tiny launches an
iteration, each a few microseconds of device work.  A fleet of same-shape
instances (parameter sweeps, max-cut over graph ensembles, SDP relaxation
batches) rides one set of launches instead: every tensor of the fused
phase bodies (solver/fused.py) gains a leading instance axis, so each
kernel (batched Cholesky, Schur products, the Lanczos and its one
``eigh``, the Ozaki kernels K1/K1s under ``kkt_hp="on"``, and with
``cone_fp="dd"`` the double-single cone factor: K8 and K1/K1s with the
fleet's N panels in one launch) runs once for the whole fleet.

Where the JAX module has ``jax.vmap`` turn every data-dependent
``lax.cond`` into a select and every ``lax.while_loop`` into a loop that
runs until the last instance is done, the port's bodies read each
decision as one flag per instance, in one host read: a branch that every
live instance takes runs alone, a split runs both branches and merges
them per instance, and a loop steps while any instance continues and
freezes the others.  Each instance therefore follows its solo trajectory
(up to the rounding of batched linear algebra, which may pick other
algorithms than the single calls on the card).

Instances that leave the common Phase A -> B path (HSD hand-off,
numerical failure, non-optimal Phase B exits) are re-solved solo, as in
the JAX module; ``Result.stats["batch_solo"]`` is 1 for those, 0 for the
fleet's own results.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import torch

from hdsdp_tpu_torch.models.problem import SDPProblem
from hdsdp_tpu_torch.ops import ddchol, hpmm
from hdsdp_tpu_torch.solver import algo, dimacs, fused
from hdsdp_tpu_torch.solver.params import Params
from hdsdp_tpu_torch.solver.solver import HDSDPSolver, Result, _host
from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.device import resolve_device


def _shape_key(ipm):
    """What must agree across a fleet (the JAX module's check): m and the
    (F, Ad, C, Fs) shapes of every group."""
    return ipm.m, tuple(
        (tuple(ga.F.shape), tuple(ga.Ad.shape), tuple(ga.C.shape),
         None if ga.Fs is None else tuple(ga.Fs.shape))
        for ga in ipm.cones.groups
    )


def solve_batch(probs: Sequence[SDPProblem], device="cuda",
                **param_overrides) -> List[Result]:
    """Solve N structurally identical instances through one set of fused
    phase bodies on ``device`` (default "cuda", which raises when no card
    is usable).

    Every instance must give the same bucketed cone shapes (same m, same
    block layout: one generator at one size with different data), else
    ValueError.  The fleet's configuration (ratio test, Lanczos depths,
    Ozaki assemblies, corrector counts, max_iter) is the first instance's.
    Instances that leave the common Phase A -> B path are re-solved solo
    with the same overrides on the same device and their solo Result
    returned.  With ``kkt_mp="on"`` each instance takes the f64 ladder of
    its Schur factor on its own (``fused._factor_m_mp``), as under the JAX
    package's vmap; ``stats["mp_f64_factors"]`` counts them per instance
    (of ``stats["mp_factors"]``)."""
    if not probs:
        return []
    with profile.span("solve"):
        return _solve_batch(probs, device, param_overrides)


def _solve_batch(probs, device, param_overrides) -> List[Result]:
    t0 = time.time()
    dev = resolve_device(device)
    param_overrides.setdefault("verbose", False)
    algo.refuse_f32_fused(Params(**param_overrides))

    def solo(i: int, why: str) -> Result:
        r = HDSDPSolver(probs[i], device=dev, **param_overrides).optimize()
        r.stats.update(batch_solo=1, batch_exit=why)
        return r

    with profile.span("ipm_setup"):
        ipms = [algo.DualIPM(prob, Params(**param_overrides), device=dev) for prob in probs]
        if any(_shape_key(ipm) != _shape_key(ipms[0]) for ipm in ipms):
            raise ValueError(
                "solve_batch needs structurally identical instances "
                "(same m and bucketed cone shapes); solve mixed shapes solo"
            )
        p0 = ipms[0].params
        cfg = fused._config_from_ipm(ipms[0])

        # ---- Phase A prologue per instance (mirrors solve_fused)
        live = []
        results: List[Result] = [None] * len(probs)  # type: ignore[list-item]
        allow_resets = set()
        for i, ipm in enumerate(ipms):
            ipm.psdp = None
            ipm.which_method = "infeas"
            f = ipm.f
            allow_resets.add(not (f.many_cones or f.implied_trace or f.very_dense))
            ipm.set_start("infeas", False)
            if not ipm.check_is_interior(ipm.tau, ipm.y):
                ipm.reset_start()
                if not ipm.check_is_interior(ipm.tau, ipm.y):
                    ipm.status = algo.NUMERICAL
                    results[i] = solo(i, "prologue: not interior")
                    continue
            live.append(i)
    if len(allow_resets) != 1:
        # feature-divergent fleet: shape-identical but policy-divergent
        # bodies; solve everything solo
        return [results[i] or solo(i, "divergent reset policy") for i in range(len(probs))]
    allow_reset = allow_resets.pop()
    if not live:
        return results

    # what the fleet's own bodies did (not the prologues, the DIMACS checks
    # or the solo re-solves), recorded in every Result's stats["fleet"]
    # once a fleet ran:
    # trips of the phase loops, KKT builds by kind, decision reads, and
    # launches of K1, K1s and (cone_fp="dd") K8
    acct = {"size": len(live), "iterations": 0, "kkt_builds": {}, "host_reads": 0,
            "kernel_launches": [0, 0, 0]}

    def drive(idx, body, st, is_phase_b):
        c = fused.stack_cones([fused._cones_from_ipm(ipms[i]) for i in idx])
        c.cfg = cfg
        k1, k1s, k8 = hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES, ddchol.PANEL_LAUNCHES

        def step(s):
            acct["iterations"] += 1
            return body(c, s)

        st = fused._drive(c, step, st, p0.max_iter, is_phase_b, True)
        acct["host_reads"] += c.n_reads
        for kind, n in c.n_builds.items():
            acct["kkt_builds"][kind] = acct["kkt_builds"].get(kind, 0) + n
        acct["kernel_launches"][0] += hpmm.KERNEL_LAUNCHES - k1
        acct["kernel_launches"][1] += hpmm.SLICE_LAUNCHES - k1s
        acct["kernel_launches"][2] += ddchol.PANEL_LAUNCHES - k8
        if cfg.mp:
            for k, i in enumerate(idx):
                ipms[i]._count("mp_factors", int(c.mp_factors[k]))
                ipms[i]._count("mp_f64_factors", int(c.mp_f64[k]))
        return st

    # ---- Phase A, the whole fleet
    with profile.span("phase"):
        pars_a = fused.stack_tree([fused._pars_from_ipm(ipms[i], "a") for i in live])
        reset_rd = torch.tensor(
            [max(-max(ipms[i].f.obj_fro_norm, 1e02) * 1e06, -1e15) for i in live],
            dtype=ipms[0].dtype).to(dev)
        st = drive(live, lambda c, s: fused._phase_a_body(c, pars_a, reset_rd, s,
                                                          p0.corrector_a, allow_reset),
                   fused.stack_tree([fused._state_from_ipm(ipms[i]) for i in live]), False)

        go_b = []
        for k, i in enumerate(live):
            ipm = ipms[i]
            fused._sync_to_ipm(fused.index_tree(st, k), ipm, fused._cones_from_ipm(ipm))
            profile.count("host_reads")
            code = int(st.status[k])
            if code == fused.DUAL_FEASIBLE:
                go_b.append(i)
            else:
                # HSD hand-off / numerical / maxiter: solo re-solve
                results[i] = solo(i, fused.phase_exit("A", code, ipm.n_iter))

    # ---- Phase B prologue per instance (mirrors solve_fused)
    for i in go_b:
        ipm = ipms[i]
        ipm.which_method = "potential"
        ipm.perturb = -10.0 * ipm.Rd
        ipm.Rd = 0.0
        if ipm.perturb != 0.0:
            ipm.check_is_interior(1.0, ipm.y)

    # ---- Phase B, the fleet that reached it (no PSDP hand-off, as in JAX)
    if go_b:
        with profile.span("phase"):
            pars_b = fused.stack_tree([fused._pars_from_ipm(ipms[i], "b") for i in go_b])
            st = drive(go_b, lambda c, s: fused._phase_b_iteration(c, pars_b, s,
                                                                   p0.corrector_b, False),
                       fused.stack_tree([fused._state_from_ipm(ipms[i]) for i in go_b]), True)
            profile.count("host_reads")
            codes = st.status.tolist()
    for k, i in enumerate(go_b):
        ipm = ipms[i]
        fused._sync_to_ipm(fused.index_tree(st, k), ipm, fused._cones_from_ipm(ipm))
        ipm.status = fused._STATUS_MAP.get(codes[k], algo.NUMERICAL)
        if ipm.status != algo.PRIMAL_DUAL_OPTIMAL:
            # (a solo solve ending phase B so is still judged by its DIMACS
            # check; the JAX module re-solves it, and so does the port)
            results[i] = solo(i, fused.phase_exit("B", codes[k], ipm.n_iter))
            continue
        errs = dimacs.check_solution(ipm)  # may refine p_obj: before it is read
        stats = dict(ipm._factor_stats)
        stats.update(fused="batch", fused_host_reads=acct["host_reads"], batch_solo=0)
        results[i] = Result(
            status=ipm.status,
            p_obj=ipm.p_obj_val,
            d_obj=ipm.d_obj_val,
            gap=ipm.p_obj_val - ipm.d_obj_val,
            y=_host(ipm.y),
            dimacs=errs,
            n_iters=ipm.n_iter,
            solve_time=time.time() - t0,
            stats=stats,
            device=str(dev),
        )
    for r in results:
        r.stats["fleet"] = dict(acct, kkt_builds=dict(acct["kkt_builds"]),
                                kernel_launches=list(acct["kernel_launches"]))
    return results
