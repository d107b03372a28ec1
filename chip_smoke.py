#!/usr/bin/env python3
"""Smoke run of hdsdp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

  1. device  require a CUDA card; print its name and power limit;
  2. build   compile every CUDA kernel of the main path from csrc/, one
             nvcc process per source, all started together;
  3. kernel  hold each kernel against its plain PyTorch version on the
             card, bit for bit, at the shapes the main path gives it and
             at ragged, wild-scale, strided, NaN and adversarial inputs
             (slices of +-256 units, where the in-chunk sums reach the
             2^24 bound of their exactness argument, and of odd units,
             where they come within 2^17 of it with their low bits set);
             show that one hpmm
             is three kernel launches; time kernel, plain version, whole
             hpmm and the f64 torch.matmul of the same product with CUDA
             events (the kernels inside a replayed CUDA graph, so that the
             host's launch cost is not what is measured), and compute each
             kernel's bound from the shapes.  K8, the double-single panel
             factor of ops/ddchol.py (csrc/dd_panel.cu), is held bit for bit
             (signed zeros included) against its plain version at B = 32,
             64, 128 and 256, each on a well-conditioned, an ill-conditioned
             (cond 1e12), an indefinite (both fail ok alike) and a
             wild-scaled panel, and a fleet of the four against its four
             single launches; the whole ddchol.factor of maxG51's start S
             (1000 padded to 1024, 4 panels) on the card against the host,
             bit for bit; K8 at every B, its plain version and f64 cholesky
             of the panel timed, and the whole factor against f64 cholesky
             of S;
  4. slice   solve the SDPLIB gpp500-class instance (gpp_sdpa(n=500,
             seed=0), m = 501, one 500 x 500 block) with kkt_hp="on" and
             fused=False (the host loop) through solve_sdpa_file, count the
             kernels' launches in that run, and hold the result to the JAX
             package's host-loop reference; then hold a small host-loop
             solve on the card to the same solve on the host;
  5. families  solve, through solve_sdpa_file with fused=False, the five
             other named instances of utils/instances.py at SDPLIB size
             (diag, bounded-support and flat Schur buckets, AdaptiveCG, PSDP)
             and hold each to its status, its DIMACS errors and the JAX
             package's host-loop objective; two of them (maxG51, theta6) are
             solved twice and must repeat bit for bit.  One JSON line per
             solve.  (Phases 4 and 5 hold the host loop, which the default
             default path no longer takes at these sizes.)
  6. fused   the default path: solve gpp500 (kkt_hp="on"), maxG51,
             torusg3-15, theta6, maxG55 and control11 through solve_sdpa_file
             with default parameters, which pick the fused phase bodies
             ("iter") by themselves, and hold each to "iter", its status, its
             DIMACS errors and the objective of the JAX package's fused run
             (FUSED_REFS); gpp500 launches K1 and K1s, theta6 hands off to
             PSDP, maxG51 repeats bit for bit; one more solve of each under
             torch.profiler, fused and host loop, counts device kernels and
             host reads per iteration.  Then gpp n = 40 (m = 41: "phase") on
             the card against the host, and "phase" against "iter" on the
             card, bit for bit.  One JSON line per instance.
  7. operator  solve theta-m25001 (theta_sdpa(n=700, n_edges=25000, seed=0),
             m = 25,001, nothing cut) through solve_sdpa_file with default
             parameters, which engage the matrix-free Schur operator by
             themselves, and hold it: optimal, no dense M in the dual solve,
             CG steps and f32 preconditioner builds counted, PSDP matrix-free,
             DIMACS max within its bound, no launch of K1/K1s, the objective
             of the JAX package's CPU run; then the same instance with
             kkt_mode="dense" (a 5 GB M, AdaptiveCG, PSDP's row-chunked
             build) as a second reference; then maxG51 (the diag bucket's shortcut) and
             random-m1000 (the generic slot-major bucket with a dense bucket)
             under kkt_mode="free" against the objectives of their dense
             solves; then time the two ways of applying the f32
             preconditioner at m = 25,001.  One JSON line per solve.
  8. api     the rest of the single-instance surface: a sparse LP of 1800
             rows and 4500 columns (utils/instances.py lp1800) written as MPS
             and solved by solve_mps_file, with default parameters and with
             the primal phase allowed from the first qualifying iteration,
             held to the JAX package's CPU objective; the ranged MPS through
             `python -m hdsdp_tpu_torch ... --json`; maxG51 solved with
             checkpoint_to and resumed in a new solver; kkt_cross_validate on
             the card; the native SDPA reader against the Python parser on
             theta-m25001's 270,000-entry file, both timed; theta6 and gpp500
             solved again in a subprocess under OMP_NUM_THREADS=2, which must
             repeat the bits of the fused phase's solves (the presolve does not
             depend on the host's thread count).  One JSON line per part.

  9. batch   solve_batch: three fleets of same-shape instances through one
             set of fused phase bodies: 16 x maxcut_sdpa(n=100) (mcp100
             class), 8 x maxcut_sdpa(n=1000) (maxG51 class) and 4 x
             gpp_sdpa(n=500) with kkt_hp="on" (gpp500 class, K1 and K1s with a
             fleet axis).  The two maxcut fleets must finish every member in
             the fleet, each held to its own solo (default, fused) solve of
             this run: status, d_obj within 1e-7, DIMACS max <= 1e-6.  The gpp
             fleet's members leave in phase B on the small-step rule, as in
             the JAX package's own fleet on the CPU, and are re-solved solo
             (which must repeat this run's solo solves bit for bit): that
             fleet holds K1 and K1s on the fleet's path, launched once per
             fleet product (K1s twice), not once per instance, and not the
             fleet's end result.  One JSON line per fleet:
             iterations beside the solo ones, the fleet's wall beside the sum
             of the solo walls, device kernels and host reads per fleet
             iteration beside one solo's, peak memory.  A fleet of mixed
             shapes must raise.  A fourth fleet, 4 x maxcut_sdpa(n=1000)
             with kkt_mp="on" (maxG51x4mp), takes the f64 ladder of its
             Schur factor per member; every member is also held to the JAX
             package's fleet (BATCH_MP_REFS: status, d_obj 1e-7), and its
             count of f64 factors is printed.  (The kernel phase also holds the fleet forms
             of K1 and K1s, at the gpp fleet's shapes, bitwise against their N
             single launches and their plain versions, and times them.)

 10. mesh1   the mesh path (hdsdp_tpu_torch.parallel) on a real NCCL group of
             one rank in this process: HDSDPSolver(prob, mesh=make_mesh("cuda:0"))
             solves maxG51 twice (the diag bucket, row-sharded, the distributed
             Cholesky padding 1000 to 1024; the two must repeat bit for bit),
             control11 (one group of three blocks: the slot-partitioned system,
             reduce_scatter), gpp500 with kkt_hp="on" (the slot bucket's rows
             through K1/K1s) and its two witnesses under the exact ratio test
             (kkt_hp off and on, log rows held too; see MESH_ROWS), theta6
             (the support bucket at m = 4375: the row-sharded CG, and PSDP
             with it) and maxG51 with kkt_mode="free" (the sharded operator
             matvec), each held to the JAX package's own
             mesh run of one device (MESH_REFS: status, d_obj 1e-7, DIMACS max
             <= max(1e-6, 10x the reference's)); then maxG51 with
             cone_fp="dd" (every cone factor on the rank through ddchol: K8
             and K1/K1s launch), with kkt_fp="dd" (inert on a mesh, as in the
             JAX package: d_obj, iterations and y bit for bit the plain
             maxG51 line's) and with dtype="float32" (d_obj within
             F32_D_OBJ_REL, its peak memory beside the plain line's); the
             group is destroyed after.
 11. mesh4   four ranks on the one card over gloo (parallel.mesh.spawn, every
             rank on cuda:0): maxG51, control11, gpp500 (kkt_hp="on": K1/K1s at
             the row-shard shapes), the two gpp500 witnesses, maxG51 with
             cone_fp="dd" (K8 must launch on every rank) and
             parallel.dryrun; every rank must end on the same y and d_obj bit
             for bit, and each solve is held to the JAX
             package's mesh run of four devices (status, d_obj 1e-7).  Both mesh
             phases print each collective's count per iteration.
             (The kernel phase also holds K1 and K1s at the 4-rank row-shard
             shapes of gpp500, [126, 500] x [500, 500] and [126, 500] x [500,
             501], bitwise against their plain versions, and times them.)

 12. dd      the double-single path (ops/ddchol.py, run after the batch
             phase): maxG51 (maxcut_sdpa(n=1000, seed=0)) through
             solve_sdpa_file (a) with cone_fp="dd" (the fused "iter" path,
             every cone factor and interior check through ddchol: K8, K1,
             K1s), (b) fused=False, kkt_fp="dd", cone_fp="dd" (the Schur
             factor by ddchol with f64 refinement), (c) kkt_hp="on" (U = S^-1
             through ddchol.spd_inverse_from_f64_tri: K1, K1s, no K8, the
             factor being the cone system's f64 one), each held to the JAX
             package's CPU run (DD_SOLVES: status, d_obj 1e-7, DIMACS <=
             1e-6) and to its launches, counted from 0 around it; (d) a fleet
             of 4 x maxcut_sdpa(n=1000, seed=s) with cone_fp="dd" through
             solve_batch (K8 and K1/K1s take the 4 instances in one launch),
             every member finished in the fleet and held to its solo solve.
 13. f32     dtype="float32" on the host loop (fused=False) through
             HDSDPSolver: maxG51 (diag bucket), control11 (flat bucket,
             three blocks) and theta6 (support bucket, AdaptiveCG), each
             held to the JAX package's float32 host loop (F32_REFS: status,
             d_obj within F32_D_OBJ_REL, DIMACS within 10x F32_DIMACS_JAX),
             the port's check on the host at the card's end state held to
             the same status and bound, with its iterations and its peak
             device memory and wall beside the same instance's float64
             host-loop solve through solve_sdpa_file; the fused driver must
             refuse float32.  (maxG51 on the mesh in float32 is a line of
             phase 10.)

The last lines are the kernel table as JSON, the card's name and power
limit, and the contract line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# Reference for gpp_sdpa(n=500, seed=0) with kkt_hp="on": the JAX
# package's host loop (fused=False) on the CPU.
REF_ITERS = 61
REF_D_OBJ = -1940.4850971721783
# The iteration count is sensitive to ~1e-7 noise in the ratio test's
# f32 Lanczos bound: 61-88 over CPU runs of both packages (PERF.md), so
# it is printed beside the reference and not held.  (An earlier form of
# the Lanczos early exit gave 63 on the card and was held to 61 +- 2; it
# took its Ritz pairs from a padded tridiagonal on which cuSOLVER's f32
# eigensolver is unsound, see ops/ratio.py.)
GMAX = 5

# References for the families phase: (iterations, d_obj) of the JAX
# package's host loop, HDSDPSolver(prob, fused=False) with default
# parameters on the CPU, for the same generator call.  The objective is
# held to 1e-7 relative; the iteration count is printed beside the card's
# and not held (it is not reproducible across platforms at this size).
FAMILY_REFS = {
    "maxG51": (33, -261.4270223134347),
    "torusg3-15": (36, -788.3130300314136),
    "theta6": (78, -63.610668448987234),
    "maxG55": (37, -1346.641369532926),
    "control11": (30, -22.033029729518017),
}
FAMILY_CG = ("theta6", "maxG55")  # m >= kkt_cg_threshold: AdaptiveCG must engage
FAMILY_PSDP = ("theta6",)  # one cone, n < m / 3: the refiner must run
FAMILY_TWICE = ("maxG51", "theta6")  # solved twice: the trajectory must repeat

# References for the fused phase (the default path, "iter" at these
# sizes): (iterations, d_obj) of the JAX package's default path ("iter"
# too) on the CPU for the same generator call and overrides, `JAX_PLATFORMS=cpu
# python tests/jax_reference.py NAME --fused auto` on 6 cores of the card's
# host (19-376 s each).  d_obj is held to 1e-7 relative; the iteration count
# is printed beside the card's and the host loop's, not held.
FUSED_REFS = {
    "gpp500": (76, -1940.485090473088),
    "maxG51": (34, -261.4270223134442),
    "torusg3-15": (39, -788.3130300314208),
    "theta6": (57, -63.61066844871744),
    "maxG55": (45, -1346.6413695329475),
    "control11": (32, -22.03302972951802),
}
FUSED_TWICE = ("maxG51",)  # solved twice: the trajectory must repeat
FUSED_PSDP = ("theta6",)  # the fused phase B must hand off to PSDP

# theta-m25001 in operator mode.  DIMACS max is held to 1e-4: PSDP at
# n = 700 contracts the gap by at most 1 - 1/sqrt(700) an iteration, cannot
# converge within its 100 iterations and leaves through its flatten exit at
# a relative gap (DIMACS error 5) of order 1e-5.  The reference is the JAX
# package's host loop on the CPU for the same generator call
# (tests/jax_reference.py theta-m25001: operator mode there too, 99
# iterations), held to 1e-6 relative.  The older record of the JAX package
# for this call (a TPU run that left PSDP at a relative gap of 6.3e-05,
# benchmarks/logs/opfree_25k_r5.log) is printed beside it, not held.
OPERATOR_DIMACS_BOUND = 1e-4
OPERATOR_JAX_REF = (99, -99.52193140329659)
OPERATOR_JAX_RECORD_D_OBJ = -99.52377458005179

# The api phase's LP (utils/instances.py "lp1800": 1800 x 4500, 1 % dense,
# seed 0) solved by the JAX package's solve_mps_file on the CPU,
# `JAX_PLATFORMS=cpu python tests/jax_reference.py --lp lp1800` (8 cores,
# 11-13 s each): primal_switch_ratio -> (iterations, phase that ended the
# solve, p_obj, d_obj).  Both settings end in the primal-dual phase: the
# switch-over conditions never hold on this LP.  Both packages stop on
# their stall rule at iteration 20 (the dual residual grows as mu -> 0) and
# return the best iterate, at a relative gap |p - d| / (|p| + |d| + 1) of
# 8.6e-08, the solver's own measure, which is what the phase holds to 1e-7.
LP_JAX_REFS = {
    0.0: (20, "pd", 1475.910834578135, 1475.9105814179402),
    1e30: (20, "pd", 1475.910834578135, 1475.9105814179402),
}
RANGED_MPS = """NAME          RANGED
ROWS
 N  COST
 L  R1
 G  R2
 E  R3
COLUMNS
    X1        COST      -1.0   R1   1.0
    X1        R2         1.0   R3   1.0
    X2        COST      -2.0   R1   1.0
    X2        R2        -1.0   R3   2.0
RHS
    RHS       R1         4.0   R2  -1.0
    RHS       R3         3.0
RANGES
    RNG       R1         2.0   R2   3.0
    RNG       R3         4.0
ENDATA
"""
RANGED_OBJ = -6.5  # 3 <= x1 + 2 x2 <= 7, hand-computed optimum
THREADS_REPEAT = ("theta6", "gpp500")  # solved again under OMP_NUM_THREADS=2

# The mesh phases' references: (instance, extra overrides, ranks) ->
# (status, iterations, d_obj, DIMACS max) of the JAX package's mesh run,
# HDSDPSolver(prob, mesh=make_mesh(ranks)) on ranks virtual CPU devices:
# `JAX_PLATFORMS=cpu python tests/jax_reference.py NAME --mesh RANKS [--kw
# '{"kkt_mode": "free"}']`, all eight at once on the card's 8-core host
# (199-1221 s each).  Held: status, d_obj 1e-7 relative, DIMACS max <=
# max(1e-6, 10x the reference's); the iterations are printed.  The JAX
# row-sharded build never passes kkt_hp on (hdsdp_tpu/parallel/schur.py:476-479),
# so its gpp500 reference assembles M in plain f64 where the port's ranks run
# K1/K1s; its gpp500 runs end at max_iter (500) and are made optimal by their
# DIMACS check (a Jacobi-PCG re-solve on a mesh: the DIMACS 1e-6 of the
# single-device phases cannot hold there, in either package).
MESH_REFS = {
    ('maxG51', '', 1): ('PRIMAL_DUAL_OPTIMAL', 33, -261.4270223134376, 8.618257426042047e-08),
    ('control11', '', 1): ('PRIMAL_DUAL_OPTIMAL', 30, -22.03302972951802, 7.995572783853506e-10),
    ('gpp500', '', 1): ('PRIMAL_DUAL_OPTIMAL', 500, -1940.485067952938, 4.7604184055905025e-05),
    ('theta6', '', 1): ('PRIMAL_DUAL_OPTIMAL', 27, -63.610704336543435, 0.0008684384299383493),
    ('maxG51', 'free', 1): ('PRIMAL_DUAL_OPTIMAL', 33, -261.4270223134194, 3.3103163384423075e-06),
    ('maxG51', '', 4): ('PRIMAL_DUAL_OPTIMAL', 33, -261.4270223134242, 8.92521124205043e-09),
    ('control11', '', 4): ('PRIMAL_DUAL_OPTIMAL', 30, -22.03302972951802, 5.793197099915196e-10),
    ('gpp500', '', 4): ('PRIMAL_DUAL_OPTIMAL', 500, -1940.4850680369414, 0.0004917027598488851),
}
# The gpp500 witnesses: the JAX row-sharded build ignores kkt_hp, and
# gpp500's phase B under the f32 Lanczos ratio test is a crawl of steps
# near 1e-3 that ends on the fourth step below 1e-3 or at max_iter, a
# count of rare events (one device: 191 iterations in the JAX package,
# 288 in the port; a mesh of one: 500 in both, on the CPU).  Under the
# exact ratio test the two packages, on one device or on a mesh, follow
# one trajectory to 1e-12 for six iterations and part as rounding grows
# (1e-9 by iteration 12).  So the port's mesh is held there, beside the
# usual holds, to the reference's log rows up to iteration 8 (d_obj and
# mu within MESH_ROWS_TOL): with kkt_hp off ("exact_off") to the JAX mesh
# run of one device, and with kkt_hp on (K1/K1s on the ranks' rows,
# "exact") to the JAX package's single-device host loop, the one JAX run
# that assembles M through hpmm.  Their status and d_obj are held to the
# JAX mesh run of the same overrides and ranks, as above.  Their DIMACS
# is printed, not held: on a mesh it comes from the Jacobi-PCG check,
# which cannot carry gpp500 (the JAX mesh run of one device gives 3.5e-04
# with kkt_hp off and 2.3e-05 with it on at the same final iterate, the
# port's 6.9e-03 on the CPU).  `tests/jax_reference.py gpp500 [--mesh N]
# --rows 8 --kw '{"ratio_test": "exact"[, "kkt_hp": "off"]}'` on an 8-core
# x86 CPU; `tests/mesh_trace.py` solves the same on the port and compares
# whole logs.
# maxG51 on a mesh with cone_fp="dd" (the DD cone factor on every
# rank) and with dtype="float32", `tests/jax_reference.py maxG51 --mesh N
# --kw '{"cone_fp": "dd"}'` (N = 1: 9 min; N = 4: 41 min) and
# `--mesh 1 --kw '{"dtype": "float32"}'` (21 s) on 3 cores of an 8-core x86
# host.  kkt_fp="dd" is inert on a mesh in the JAX package (its systems are
# row-sharded, so the Schur factor never reaches _direct_factor): its line
# is held to the plain maxG51 line of the same run bit for bit, and to the
# plain reference.  The float32 run is held as the f32 phase holds its
# solves (F32_D_OBJ_REL); its DIMACS max to min(1e-2, max(1e-6, 10 x
# F32_MESH_DIMACS_JAX)), the float64 rule on the widest reading of the
# JAX package's float32 mesh run: `tests/jax_reference.py maxG51 --mesh 1
# --kw '{"dtype": "float32"}'` pinned to 1, 2, 3, 4 and 8 cores reads
# 1.1e-4, 6.8e-6, 6.8e-6, 1.4e-4 and 9.3e-3 (29 to 32 iterations; the
# check's re-solve on a mesh is matrix-free Jacobi-PCG, in float32 here),
# so the 1e-2 that decides the status is the bound.
F32_MESH_DIMACS_JAX = 9.294669165622133e-03
MESH_REFS.update({
    ('maxG51', 'cone_dd', 1): ('PRIMAL_DUAL_OPTIMAL', 33, -261.4270223132595, 8.896723151857382e-07),
    ('maxG51', 'kkt_dd', 1): MESH_REFS[('maxG51', '', 1)],
    ('maxG51', 'f32', 1): ('PRIMAL_DUAL_OPTIMAL', 32, -261.42706298828125, 6.757726644830665e-06),
    ('maxG51', 'cone_dd', 4): ('PRIMAL_DUAL_OPTIMAL', 33, -261.4270223132629, 1.0219884004336912e-06),
})
MESH_REFS.update({
    ('gpp500', 'exact_off', 1): ('PRIMAL_DUAL_OPTIMAL', 46, -1940.4850587882843, 0.0003545750800426915),
    ('gpp500', 'exact_off', 4): ('PRIMAL_DUAL_OPTIMAL', 44, -1940.485058790709, 2.320522997180106e-05),
    ('gpp500', 'exact', 1): ('PRIMAL_DUAL_OPTIMAL', 46, -1940.4850587882843, 2.3205284273957847e-05),
    ('gpp500', 'exact', 4): ('PRIMAL_DUAL_OPTIMAL', 44, -1940.485058790709, 2.320522151746321e-05),
})
MESH_ROWS = {  # (method, iteration, d_obj, mu) up to iteration 8
    "exact_off": [
        ('infeas', 1, -2855104.9950857507, 270.46271117676434),
        ('infeas', 2, -2404947.3704469153, 13778.801144663994),
        ('potential', 2, -744557.4174162813, 2745.2500374098704),
        ('potential', 3, -39310.91080904386, 480.2703460537638),
        ('potential', 4, -35416.09172762768, 69.18709334793009),
        ('potential', 5, -3742.6682332502487, 13.788491902316057),
        ('potential', 6, -2082.947209476749, 2.1800497795939333),
        ('potential', 7, -2346.2124033303917, 4.803403876517422),
        ('potential', 8, -2845.168378965487, 5.318395623072791),
    ],
    "exact": [
        ('infeas', 1, -2855104.995085733, 270.46271117676434),
        ('infeas', 2, -2404947.3704468985, 13778.801144663992),
        ('potential', 2, -744557.4174161911, 2745.2500374097754),
        ('potential', 3, -39310.910809038265, 480.2703460533204),
        ('potential', 4, -35416.09172616633, 69.18709334551774),
        ('potential', 5, -3742.6682331898737, 13.788491901264786),
        ('potential', 6, -2082.9472094759217, 2.180049778772681),
        ('potential', 7, -2346.212403256747, 4.803403872498037),
        ('potential', 8, -2845.168378600338, 5.318395618151284),
    ],
}
MESH_ROWS_TOL = 1e-8
MESH_KW = {"": {}, "free": {"kkt_mode": "free"}, "exact": {"ratio_test": "exact"},
           "exact_off": {"ratio_test": "exact", "kkt_hp": "off"},
           "cone_dd": {"cone_fp": "dd"}, "kkt_dd": {"kkt_fp": "dd"},
           "f32": {"dtype": "float32"}}
MESH_TIMEOUT = 120.0  # seconds, every collective of a mesh phase

# The batch phase's fleets: (name, generator in models/synthetic.py, its
# arguments, fleet size, overrides); instance s is generated with seed=s.
BATCH_FLEETS = (
    ("mcp100x16", "maxcut_sdpa", {"n": 100}, 16, {}),
    ("maxG51x8", "maxcut_sdpa", {"n": 1000}, 8, {}),
    ("gpp500x4", "gpp_sdpa", {"n": 500}, 4, {"kkt_hp": "on"}),
    ("maxG51x4mp", "maxcut_sdpa", {"n": 1000}, 4, {"kkt_mp": "on"}),
)
# The mixed-precision fleet's JAX reference: the JAX package's solve_batch
# of the same four instances with kkt_mp="on" on the CPU, `JAX_PLATFORMS=cpu
# python tests/jax_reference.py maxG51 --batch 4 --kw '{"kkt_mp": "on"}'` (166
# s on 3 cores of an 8-core x86 host): every member finished in the fleet,
# (status, iterations, d_obj) per member; held: status, d_obj 1e-7.
BATCH_MP_REFS = (
    ("PRIMAL_DUAL_OPTIMAL", 34, -261.42702231344725),
    ("PRIMAL_DUAL_OPTIMAL", 36, -271.8973857417746),
    ("PRIMAL_DUAL_OPTIMAL", 35, -258.7557923851299),
    ("PRIMAL_DUAL_OPTIMAL", 33, -274.4927745631744),
)

# The f32 phase's references: the JAX package's host loop with
# dtype="float32" (fused=False) on the CPU, `JAX_PLATFORMS=cpu python
# tests/jax_reference.py NAME --kw '{"dtype": "float32"}'` on 3 cores of an
# 8-core x86 host (15, 281 and 126 s): (status, iterations, d_obj, DIMACS
# max).  Its float32 loop widens to float64 during the solve (y does, b does
# not) and ends on a float32 DIMACS evaluation, so d_obj is a float32 dot
# of b and y.  Held: status, d_obj within F32_D_OBJ_REL, DIMACS max within
# max(1e-6, 10 x F32_DIMACS_JAX), and the same status from the port's
# check run on the host at the card's end state.  The d_obj tolerance: the
# JAX package's float32 runs differ from its float64 runs by 4.2e-9
# (theta6), 9.4e-8 (control11) and 3.1e-7 (maxG51), a float32 unit is
# 6e-8 relative, and the port's float32 host loop on the CPU met the JAX
# package's within 1.1e-7 on the instances of tests/test_torch_f32.py: the
# card's float32 phase A rounds in yet another order, so the hold allows
# about three times the widest float32-to-float64 gap.
F32_D_OBJ_REL = 1e-6
F32_REFS = {
    "maxG51": ("PRIMAL_DUAL_OPTIMAL", 30, -261.42694091796875, 2.5049973240220446e-06),
    "control11": ("PRIMAL_DUAL_OPTIMAL", 30, -22.03302764892578, 2.100303023467146e-06),
    "theta6": ("PRIMAL_DUAL_OPTIMAL", 67, -63.61066818237305, 1.3180000451029628e-06),
}
# A float32 check lands on whichever maker's dual slack the float32
# Cholesky accepts, and at the last makers that is decided by rounding
# (their Sbar has lambda_min / lambda_max of -3e-8 to +2e-7, inside the
# float32 assembly's own error; tests/f32_check_witness.py, PERF.md §6):
# so the DIMACS bound is set from the worse of the two makers'
# readings in the JAX package's float32 runs (the maker the check falls
# back to).  maxG51: the inaccurate maker at the end state of its run
# above, 7.8e-5 (`tests/f32_check_witness.py solve maxG51 --package jax`);
# its host-loop runs on 1, 2, 3 and 8 cores read 2.0e-6 to 2.5e-6.
# control11: its accurate maker never factors in float32, so the readings
# are the inaccurate maker's: the 3-core run above is held (on 1, 2 and 8
# cores it reads 2.116e-6, 2.100e-6 and 2.069e-6).  theta6:
# 1.3e-6 on 3 cores; on 8 cores the run keeps no accurate maker and ends
# on PSDP's X at 5.2e-7, and its inaccurate maker reads 1.9e-4 (the check
# at its end state loaded afresh, `tests/f32_check_witness.py check theta6`).
F32_DIMACS_JAX = {"maxG51": 7.795246717228183e-05, "control11": 2.100303023467146e-06,
                  "theta6": 1.8565017300221562e-04}
# control11 alone may end NUMERICAL on the card: its inaccurate maker's
# exact margin is lambda_min = 1.65e-7 lambda_max, the card's float32
# assembly of Sbar moves it by 2.2e-6 to 2.4e-6 lambda_max (the host's by
# 4.1e-7 to 5.2e-7, in both packages), so the card's check refuses both
# makers at the card's end state and at the JAX and port CPU runs' end
# states alike, while both packages' CPU checks accept the card's end
# state at DIMACS 2.2e-6 (tests/f32_check_witness.py on the card and on
# the host, PERF.md §6).  The phase then holds the port's host
# check of the card's end state to the reference's status and bound.
F32_CARD_CHECK_REFUSES = ("control11",)
BATCH_KERNEL_FLEET = 4  # the gpp fleet's size: K1/K1s are held at its shapes

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
PEAK_BYTES_S = 3.35e12    # HBM3
PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 in, f32 accumulate
PEAK_F32_FLOPS = 67e12    # CUDA cores, an FMA counted as two operations
# the kernels below K1 issue no FMA (every step is an __f*_rn intrinsic,
# one instruction, one operation): their peak is half the FMA rate
PEAK_F32_OPS = PEAK_F32_FLOPS / 2


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 20) -> float:
    """Device time per call: reps calls captured in one CUDA graph and
    replayed between two events, so the host's launch cost (tens of
    microseconds a call, more than these kernels take) stays out."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _same(x, y) -> bool:
    """Bitwise equality of two tensors, NaN equal to NaN (a NaN's payload
    is not part of the contract)."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if not x.dtype.is_floating_point:
        return torch.equal(x, y)
    nx, ny = x.isnan(), y.isnan()
    return torch.equal(nx, ny) and torch.equal(x.masked_fill(nx, 0), y.masked_fill(ny, 0))


def _require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _pairs_bound_ms(m, n, kp, gmax):
    """(bound ms, which peak) of one pair accumulation: slices read once,
    (Ch, Cl) written once, against the bf16 MMAs of every pair."""
    q, pairs = gmax + 1, (gmax + 1) * (gmax + 2) // 2
    t_bytes = (2 * q * (m + n) * kp + 2 * 4 * m * n) / PEAK_BYTES_S
    t_ops = 2.0 * pairs * m * n * kp / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _slice_bound_ms(rows, k, kp, gmax):
    """(bound ms, which peak) of slicing one f64 operand: 8 bytes read per
    element, 2q written per padded element plus the exponents; per slice a
    multiply, a trunc, a multiply and the 7-operation two_sum remainder."""
    q = gmax + 1
    t_bytes = (8 * rows * k + 2 * q * rows * kp + 4 * rows) / PEAK_BYTES_S
    t_ops = (10.0 * q + 4.0) * rows * kp / PEAK_F32_OPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _max_abs_diff(x, y) -> float:
    """max |x - y| over the entries where both are finite."""
    import torch

    x, y = x.to(torch.float64), y.to(torch.float64)
    finite = torch.isfinite(x) & torch.isfinite(y)
    return float((x - y)[finite].abs().max()) if bool(finite.any()) else 0.0


def _check_slice(hpmm, name, x, axis, gmax=GMAX, kpad=None):
    """K1s against slice_ref on one operand; returns the kernel's output
    and max |diff| over slices and exponents."""
    import torch

    before = hpmm.SLICE_LAUNCHES
    sl, e = hpmm.hpmm_slice(x, axis, gmax, kpad)
    _require(hpmm.SLICE_LAUNCHES == before + 1, f"hpmm_slice did not count its launch at {name}")
    sl_r, e_r = hpmm.slice_ref(x, axis, gmax, kpad)
    torch.cuda.synchronize()
    _require(_same(sl, sl_r), f"hpmm_slice: slices differ from slice_ref at {name}")
    _require(torch.equal(e, e_r), f"hpmm_slice: exponents differ from slice_ref at {name}")
    return sl, e, max(_max_abs_diff(sl, sl_r), _max_abs_diff(e, e_r))


def _check_pairs(hpmm, name, a_sl, b_sl, gmax=GMAX):
    """K1 against matmul_sliced_ref on given slices; returns max |diff|."""
    import torch

    before = hpmm.KERNEL_LAUNCHES
    ch_k, cl_k = hpmm.hpmm_pairs(a_sl, b_sl, gmax)
    _require(hpmm.KERNEL_LAUNCHES == before + 1, f"hpmm_pairs did not count its launch at {name}")
    ch_r, cl_r = hpmm.matmul_sliced_ref(a_sl, b_sl, gmax)
    torch.cuda.synchronize()
    ok = _same(ch_k, ch_r) and _same(cl_k, cl_r)
    if not ok:
        bad = (ch_k != ch_r) | (cl_k != cl_r)
        i, j = (int(v) for v in bad.nonzero()[0])
        raise AssertionError(
            f"hpmm_pairs differs from matmul_sliced_ref at {name}: {int(bad.sum())} of "
            f"{bad.numel()} entries, first ({i}, {j}): kernel ({float(ch_k[i, j])!r}, "
            f"{float(cl_k[i, j])!r}) plain ({float(ch_r[i, j])!r}, {float(cl_r[i, j])!r})")
    return max(_max_abs_diff(ch_k, ch_r), _max_abs_diff(cl_k, cl_r))


def _count_device_kernels(fn):
    """Names of the device kernels one call of fn launches (profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]


def _kernel_phase(hpmm, hpmm_cases, dev):
    """Both kernels against their plain versions on the card; returns the
    worst max |diff| of K1 and of K1s, and the timings and bounds."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def operands(m, k, n, wild=False):
        a = rng.standard_normal((m, k))
        b = rng.standard_normal((k, n))
        if wild:  # rows/cols spanning 60 decades (tests/test_hpmm.py)
            a *= np.logspace(-30, 30, m)[:, None]
            b *= np.logspace(25, -25, n)[None, :]
        return (torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev))

    # The two products of the slice's Schur assembly (r = 1, m = 501,
    # n = 500), with the views and strides ops/schur.py passes:
    #   FU = hpmm(Fs.reshape(r * m, n), U[0])   and
    #   T  = hpmm(FU[j], Fs[k].T): B is a [500, 501] transposed view
    fs = torch.as_tensor(rng.standard_normal((1, 501, 500)), device=dev)
    u = torch.as_tensor(rng.standard_normal((1, 500, 500)), device=dev)
    fu = torch.as_tensor(rng.standard_normal((1, 501, 500)), device=dev)
    # ... and the same two products on one rank's rows of a 4-rank mesh
    # (m_pad = 504, 126 rows a rank: parallel.schur.row_view takes Fs[:, r0:r1]
    # for the row side; the column side is the whole Fs)
    cases = [
        ("FU [501,500]@[500,500]", fs.reshape(501, 500), u[0]),
        ("pair [501,500]@[500,501]", fu[0], fs[0].T),
        ("FU rows [126,500]@[500,500]", fs[:, 126:252].reshape(126, 500), u[0]),
        ("pair rows [126,500]@[500,501]", fu[0, 126:252], fs[0].T),
        ("ragged [37,300]@[300,45]", *operands(37, 300, 45)),
        ("wild [96,96]@[96,96]", *operands(96, 96, 96, wild=True)),
    ]
    _require(not cases[1][2].is_contiguous(), "the pair case's B is not a transposed view")
    worst = worst_slice = 0.0
    times = {}
    for name, a, b in cases:
        a_sl, ea, err_a = _check_slice(hpmm, name + " A", a, 1)
        b_sl, eb, err_b = _check_slice(hpmm, name + " B", b, 0)
        worst_slice = max(worst_slice, err_a, err_b)
        err = _check_pairs(hpmm, name, a_sl, b_sl)
        # the f64-epilogue form against the two-step form, bitwise
        ch, cl = hpmm.hpmm_pairs(a_sl, b_sl, GMAX)
        two_step = ((ch.to(torch.float64) + cl.to(torch.float64))
                    * hpmm._pow2(ea, torch.float64) * hpmm._pow2(eb, torch.float64))
        fused = hpmm.hpmm_pairs(a_sl, b_sl, GMAX, ea, eb, out_f64=True)
        c = hpmm.hpmm(a, b, GMAX)
        _require(_same(fused, two_step) and _same(c, two_step),
                 f"the f64 epilogue differs from the two-step form at {name}")
        sh, sl_ = hpmm.hpmm_pairs(a_sl, b_sl, GMAX, ea, eb)
        s = hpmm._pow2(ea, torch.float32) * hpmm._pow2(eb, torch.float32)
        _require(_same(sh, ch * s) and _same(sl_, cl * s),
                 f"the f32-scaled epilogue differs from the two-step form at {name}")
        # the whole hpmm against f64 (hpmm keeps ~48 bits: 2^-45 relative)
        ref = a @ b
        rel = float((c - ref).abs().max() / ref.abs().max())
        print(f"[kernel] {name}: slices {tuple(a_sl.shape)} x {tuple(b_sl.shape)}; "
              f"K1s == slice_ref, K1 == matmul_sliced_ref, f64 epilogue == two-step: "
              f"bitwise; max|diff| {err}; hpmm rel err vs f64 matmul {rel:.3e}", flush=True)
        _require(rel < 1e-12, f"hpmm relative error {rel} at {name}")
        worst = max(worst, err)
        if name.startswith(("FU", "pair")):
            key = "_".join(name.split()[:2]) if " rows " in name else name.split()[0]
            m, k = a.shape
            n = b.shape[1]
            t = {
                # device times (graph replay): the kernels and the library call
                "pairs": _device_ms(lambda: hpmm.hpmm_pairs(a_sl, b_sl, GMAX)),
                "pairs_f64": _device_ms(
                    lambda: hpmm.hpmm_pairs(a_sl, b_sl, GMAX, ea, eb, out_f64=True)),
                "slice_a": _device_ms(lambda: hpmm.hpmm_slice(a, 1, GMAX)),
                "slice_b": _device_ms(lambda: hpmm.hpmm_slice(b, 0, GMAX)),
                "matmul": _device_ms(lambda: a @ b),
                "hpmm_device": _device_ms(lambda: hpmm.hpmm(a, b, GMAX)),
                # eager times (host launch cost included)
                "pairs_plain": _time_ms(lambda: hpmm.matmul_sliced_ref(a_sl, b_sl, GMAX)),
                "slice_a_plain": _time_ms(lambda: hpmm.slice_ref(a, 1, GMAX)),
                "slice_b_plain": _time_ms(lambda: hpmm.slice_ref(b, 0, GMAX)),
                "pairs_eager": _time_ms(lambda: hpmm.hpmm_pairs(a_sl, b_sl, GMAX)),
                "slice_eager": _time_ms(lambda: hpmm.hpmm_slice(a, 1, GMAX)),
                "matmul_eager": _time_ms(lambda: a @ b),
                "hpmm": _time_ms(lambda: hpmm.hpmm(a, b, GMAX)),
                "pairs_bound": _pairs_bound_ms(m, n, a_sl.shape[2], GMAX),
                "slice_a_bound": _slice_bound_ms(m, k, a_sl.shape[2], GMAX),
                "slice_b_bound": _slice_bound_ms(n, k, a_sl.shape[2], GMAX),
            }
            times[key] = t
            print(f"[kernel] {name} device ms (CUDA events around a graph of 20 calls): "
                  f"K1 {t['pairs']:.4f} (f64 epilogue {t['pairs_f64']:.4f}, bound "
                  f"{t['pairs_bound'][0]:.5f} by {t['pairs_bound'][1]})  K1s A {t['slice_a']:.4f} "
                  f"B {t['slice_b']:.4f} (bound A "
                  f"{t['slice_a_bound'][0]:.5f} B {t['slice_b_bound'][0]:.5f} by "
                  f"{t['slice_a_bound'][1]})  f64 torch.matmul {t['matmul']:.4f}  "
                  f"whole hpmm {t['hpmm_device']:.4f}", flush=True)
            print(f"[kernel] {name} eager ms per call, host launch cost included (20 calls): "
                  f"K1 {t['pairs_eager']:.4f} (plain {t['pairs_plain']:.4f})  K1s A "
                  f"{t['slice_eager']:.4f} (plain A {t['slice_a_plain']:.4f} B "
                  f"{t['slice_b_plain']:.4f})  f64 torch.matmul {t['matmul_eager']:.4f}  "
                  f"whole hpmm {t['hpmm']:.4f}", flush=True)

    # -- other gmax, layouts and strides, at the ragged shape --------------
    a, b = operands(37, 300, 45)
    for gmax in (0, 3, 7):
        a_sl, _, err_a = _check_slice(hpmm, f"gmax {gmax} A", a, 1, gmax)
        b_sl, _, err_b = _check_slice(hpmm, f"gmax {gmax} B", b, 0, gmax)
        worst_slice = max(worst_slice, err_a, err_b)
        worst = max(worst, _check_pairs(hpmm, f"gmax {gmax}", a_sl, b_sl, gmax))
    a_sl, _ = hpmm.hpmm_slice(a, 1)
    b_sl, _ = hpmm.hpmm_slice(b, 0)
    _require(b_sl.stride(1) == 1, "K1s does not hand K1 a column-major (K-contiguous) B")
    layouts = {
        "a strided row view of A": (hpmm.hpmm_slice(torch.cat([a, a]), 1)[0][:, ::2], b_sl),
        "more slices than gmax uses": (hpmm.hpmm_slice(a, 1, 7)[0], hpmm.hpmm_slice(b, 0, 7)[0]),
    }
    for name, (x_sl, y_sl) in layouts.items():
        worst = max(worst, _check_pairs(hpmm, name, x_sl, y_sl))
    # what the kernel cannot stage is refused, not computed another way
    refused = {
        "an N-contiguous B": (a_sl, b_sl.contiguous()),
        "an unaligned A": (torch.cat([a_sl[:, :, :1], a_sl], 2)[:, :, 1:], b_sl),
    }
    for name, (x_sl, y_sl) in refused.items():
        before = hpmm.KERNEL_LAUNCHES
        try:
            hpmm.hpmm_pairs(x_sl, y_sl, GMAX)
        except ValueError:
            pass
        else:
            raise AssertionError(f"hpmm_pairs took {name}")
        _require(hpmm.KERNEL_LAUNCHES == before, f"hpmm_pairs counted a launch at {name}")
    big = torch.as_tensor(rng.standard_normal((80, 90)), device=dev)
    views = {
        "a transposed view": big.T,
        "a strided row view": big[::2],
        "a strided column view": big[:, ::3],
        "a K above one tile": torch.as_tensor(rng.standard_normal((20, 1300)), device=dev),
    }
    for name, x in views.items():
        for axis in (0, 1):
            worst_slice = max(
                worst_slice,
                _check_slice(hpmm, f"{name}, axis {axis}", x, axis)[2],
                _check_slice(hpmm, f"{name} as a double-single pair, axis {axis}",
                             hpmm.dd.from_f64(x), axis)[2])
    worst_slice = max(worst_slice, _check_slice(hpmm, "a wider K pad", a, 1, kpad=768)[2])
    nan_a = a.clone()
    nan_a[3, 4] = float("nan")
    nan_a[7, :] = 0.0
    nan_sl, _, err_a = _check_slice(hpmm, "a NaN row and a zero row", nan_a, 1)
    err_b = _check_slice(hpmm, "a NaN column and a zero column", nan_a.T, 0)[2]
    worst_slice = max(worst_slice, err_a, err_b)
    worst = max(worst, _check_pairs(hpmm, "a NaN row", nan_sl, b_sl))
    c = hpmm.hpmm(nan_a, b)
    _require(bool(c[3].isnan().all()) and bool(torch.isfinite(c[[0, 7]]).all()),
             "NaN did not stay in its row")
    print(f"[kernel] gmax 0/3/7, a column-major B, {len(layouts)} more slice layouts, "
          f"{len(views)} strided inputs (f64 and double-single, both axes), a wider K pad, "
          f"NaN and zero rows: bitwise; {len(refused)} layouts the kernel cannot stage: "
          f"refused", flush=True)

    # -- adversarial: slice entries of +-256 units, and of odd units ------------
    peaks = {}
    for k in (256, 512, 1024):
        for kind in hpmm_cases.KINDS:
            ia, ib = hpmm_cases.adversarial_ints(kind, 70, k, 41, GMAX + 1, seed=k)
            ch_x, cl_x, peak, low_bits = hpmm_cases.exact_pairs_ref(ia, ib, GMAX)
            a_sl = torch.as_tensor(hpmm_cases.slices_from_ints(ia), device=dev).to(torch.bfloat16)
            b_kn = torch.as_tensor(hpmm_cases.slices_from_ints(ib), device=dev).to(torch.bfloat16)
            # K-contiguous B storage, the layout the main path hands K1
            b_sl = b_kn.transpose(1, 2).contiguous().transpose(1, 2)
            name = f"adversarial {kind}, K = {k}"
            worst = max(worst, _check_pairs(hpmm, name, a_sl, b_sl))
            ch, cl = hpmm.hpmm_pairs(a_sl, b_sl, GMAX)
            _require(np.array_equal(ch.cpu().numpy(), ch_x)
                     and np.array_equal(cl.cpu().numpy(), cl_x),
                     f"hpmm_pairs differs from the int64 reference at {name}")
            peaks[kind] = (peak, low_bits)
    _require(peaks["same"] == (2 ** 24, False), "the +256 case misses the 2^24 bound")
    _require(peaks["odd_same"] == (2 ** 24 - 130816, True) and peaks["odd_random"][1],
             "the odd cases do not set low bits near the 2^24 bound")
    print(f"[kernel] adversarial slices at K = 256/512/1024, +-256 units (same, alternating, "
          f"random signs) and odd units of equal sign (all 255; random odd <= 255): K1 == "
          f"matmul_sliced_ref == int64 reference, bitwise; largest in-chunk sum in units, and "
          f"whether bits below 2^16 units are set: {peaks}", flush=True)

    # -- the wrappers that reuse the two kernels, card against host ------------
    a = torch.as_tensor(rng.standard_normal((501, 500)), device=dev)
    b = torch.as_tensor(rng.standard_normal((500, 64)), device=dev)
    ah, al = hpmm.dd.from_f64(a)
    bh, bl = hpmm.dd.from_f64(b)

    def presliced(x, y):
        return hpmm.hpmm_presliced(*hpmm.hpmm_slice_a(x), y)

    wrappers = {
        "hpmm_syrk [501,500]": (hpmm.hpmm_syrk, (a,)),
        "hpmm_slice_a + hpmm_presliced": (presliced, (a, b)),
        "hpmm_dd": (hpmm.hpmm_dd, (ah, al, bh, bl)),
        "hpmm_dd_syrk [501,500]": (hpmm.hpmm_dd_syrk, (ah, al)),
    }
    for name, (fn, args) in wrappers.items():
        k0, s0 = hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES
        got = fn(*args)
        launched = (hpmm.KERNEL_LAUNCHES - k0, hpmm.SLICE_LAUNCHES - s0)
        want = fn(*(x.cpu() for x in args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        _require(all(_same(g.cpu(), w) for g, w in zip(got, want)),
                 f"{name} on the card differs from the plain versions on the host")
        print(f"[kernel] {name}: card == host plain versions bitwise; launches "
              f"(K1, K1s) = {launched}", flush=True)

    # -- one hpmm is three launches ---------------------------------------------
    a, b = cases[1][1], cases[1][2]
    k0, s0 = hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES
    hpmm.hpmm(a, b)
    counted = (hpmm.KERNEL_LAUNCHES - k0, hpmm.SLICE_LAUNCHES - s0)
    names = _count_device_kernels(lambda: hpmm.hpmm(a, b))
    print(f"[kernel] one hpmm at the pair shape: counters (K1, K1s) = {counted}; device "
          f"kernels seen by the profiler: {len(names)} {names}", flush=True)
    _require(counted == (1, 2), f"one hpmm counted {counted} launches, not (1, 2)")
    _require(len(names) == 3 and sum("hpmm_slice" in n for n in names) == 2
             and sum("hpmm_pairs" in n for n in names) == 1,
             f"one hpmm ran {names} on the device, not its three kernels")
    return worst, worst_slice, times


def _fleet_kernel_phase(hpmm, dev):
    """K1 and K1s with a fleet axis, at the gpp fleet's shapes (4 instances
    of the two products of gpp500's Schur assembly): one launch each,
    bitwise equal to the N single launches and to the plain versions;
    timed (CUDA events around a replayed graph) against their bound at the
    fleet shape.  Returns (worst K1 diff, worst K1s diff, times)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    n_f = BATCH_KERNEL_FLEET
    fs = torch.as_tensor(rng.standard_normal((n_f, 501, 500)), device=dev)
    u = torch.as_tensor(rng.standard_normal((n_f, 500, 500)), device=dev)
    fu = torch.as_tensor(rng.standard_normal((n_f, 501, 500)), device=dev)
    worst = worst_slice = 0.0
    times = {}
    for name, a, b in (("FU", fs, u), ("pair", fu, fs.transpose(1, 2))):
        k0, s0 = hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES
        a_sl, ea = hpmm.hpmm_slice(a, 1, GMAX)
        b_sl, eb = hpmm.hpmm_slice(b, 0, GMAX)
        c = hpmm.hpmm_pairs(a_sl, b_sl, GMAX, ea, eb, out_f64=True)
        ch, cl = hpmm.hpmm_pairs(a_sl, b_sl, GMAX)
        launched = (hpmm.KERNEL_LAUNCHES - k0, hpmm.SLICE_LAUNCHES - s0)
        _require(launched == (2, 2), f"the fleet's {name} product launched {launched}")
        singles = [hpmm.slice_operands(a[i], b[i], GMAX) for i in range(n_f)]
        for i, (sa, sb, sea, seb) in enumerate(singles):
            _require(_same(a_sl[i], sa) and _same(b_sl[i], sb) and torch.equal(ea[i], sea)
                     and torch.equal(eb[i], seb),
                     f"fleet K1s differs from its single launches at {name}[{i}]")
            _require(_same(c[i], hpmm.hpmm_pairs(sa, sb, GMAX, sea, seb, out_f64=True)),
                     f"fleet K1 differs from its single launch at {name}[{i}]")
        sl_r, e_r = hpmm.slice_ref(a, 1, GMAX)
        slb_r, eb_r = hpmm.slice_ref(b, 0, GMAX)
        ch_r, cl_r = hpmm.matmul_sliced_ref(a_sl, b_sl, GMAX)
        c_r = hpmm.pairs_ref(a_sl, b_sl, GMAX, ea, eb, out_f64=True)
        torch.cuda.synchronize()
        _require(_same(a_sl, sl_r) and _same(b_sl, slb_r) and torch.equal(ea, e_r)
                 and torch.equal(eb, eb_r), f"fleet K1s differs from slice_ref at {name}")
        _require(_same(ch, ch_r) and _same(cl, cl_r) and _same(c, c_r),
                 f"fleet K1 differs from its plain version at {name}")
        worst = max(worst, _max_abs_diff(ch, ch_r), _max_abs_diff(cl, cl_r),
                    _max_abs_diff(c, c_r))
        worst_slice = max(worst_slice, _max_abs_diff(a_sl, sl_r), _max_abs_diff(b_sl, slb_r))
        m, k = a.shape[1:]
        n = b.shape[2]
        kp = a_sl.shape[-1]
        pb, pby = _pairs_bound_ms(m, n, kp, GMAX)
        sab, sby = _slice_bound_ms(m, k, kp, GMAX)
        sbb, _ = _slice_bound_ms(n, k, kp, GMAX)
        t = {
            "pairs_f64": _device_ms(lambda: hpmm.hpmm_pairs(a_sl, b_sl, GMAX, ea, eb,
                                                            out_f64=True)),
            "pairs_singles_f64": _device_ms(lambda: [
                hpmm.hpmm_pairs(sa, sb, GMAX, sea, seb, out_f64=True)
                for sa, sb, sea, seb in singles]),
            "slice_a": _device_ms(lambda: hpmm.hpmm_slice(a, 1, GMAX)),
            "slice_b": _device_ms(lambda: hpmm.hpmm_slice(b, 0, GMAX)),
            "matmul": _device_ms(lambda: a @ b),
            "pairs_plain": _time_ms(lambda: hpmm.matmul_sliced_ref(a_sl, b_sl, GMAX), reps=5),
            "slice_a_plain": _time_ms(lambda: hpmm.slice_ref(a, 1, GMAX), reps=5),
            "slice_b_plain": _time_ms(lambda: hpmm.slice_ref(b, 0, GMAX), reps=5),
            # the whole fleet's work: N times one instance's
            "pairs_bound": (n_f * pb, pby),
            "slice_a_bound": (n_f * sab, sby),
            "slice_b_bound": (n_f * sbb, sby),
        }
        times[name] = t
        print(f"[kernel] fleet {name} x{n_f}: slices {tuple(a_sl.shape)} x {tuple(b_sl.shape)}; "
              f"one K1 and one K1s launch per operand, == the {n_f} single launches and the "
              f"plain versions bitwise; device ms (graph of 20 calls): K1 {t['pairs_f64']:.4f} "
              f"({n_f} single launches {t['pairs_singles_f64']:.4f}, bound "
              f"{t['pairs_bound'][0]:.5f} by {t['pairs_bound'][1]})  K1s A {t['slice_a']:.4f} "
              f"B {t['slice_b']:.4f} (bound A {t['slice_a_bound'][0]:.5f} B "
              f"{t['slice_b_bound'][0]:.5f} by {t['slice_a_bound'][1]})  batched f64 "
              f"torch.matmul {t['matmul']:.4f}; plain eager ms K1 {t['pairs_plain']:.4f} K1s A "
              f"{t['slice_a_plain']:.4f} B {t['slice_b_plain']:.4f}", flush=True)
    return worst, worst_slice, times


def _bits_same(x, y) -> bool:
    """Bit-for-bit equality of two float tensors, signed zeros told apart
    and NaN equal to NaN (a NaN's payload is not part of the contract)."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    nx, ny = x.isnan(), y.isnan()
    iv = torch.int32 if x.dtype == torch.float32 else torch.int64
    return (torch.equal(nx, ny)
            and torch.equal(x.masked_fill(nx, 0).view(iv), y.masked_fill(ny, 0).view(iv)))


def _panel_ops(b):
    """The f32 operations that L and W of one B x B panel need, counted
    from dd.py's code (DD product 24, DD sum or difference 11, a negation
    free, sqrt 35 and inv 41 for the pivot); step j, r = B - 1 - j rows
    below the pivot:
      pivot:    76
      column:   24 (r + 1)           a DD product per entry of L[j:, j]
      trailing: 35 r (r + 1) / 2     a DD product and a DD difference per
                                     entry of the trailing block's lower
                                     triangle, all that later steps read
      W row j:  sum over k < j of 24 (j - k) + 11 (j - k - 1) + 24: the
                products L[j, i] W[i, k] for k <= i < j (W is lower
                triangular), their DD sum and the product with the
                pivot's inverse; W[j, j] is that inverse.
    About 35 B^3 / 3.  K8 runs about 70 B^3: it updates the whole panel
    and sums every row, as the plain version does."""
    ops = 0
    for j in range(b):
        r = b - 1 - j
        ops += 76 + 24 * (r + 1) + 35 * r * (r + 1) // 2
        ops += sum(24 * d + 11 * (d - 1) + 24 for d in range(1, j + 1))
    return ops


def _panel_bound_ms(b, n_inst=1):
    """(bound ms, which peak) of K8 on n_inst panels of B x B: the two
    input words read once and the four output words written once, against
    the operations of :func:`_panel_ops` at the FMA-free f32 rate."""
    t_bytes = n_inst * 6 * 4 * b * b / PEAK_BYTES_S
    t_ops = n_inst * _panel_ops(b) / PEAK_F32_OPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _maxg51_start_s(torch, dev):
    """maxG51's dual slack S at the IPM's first interior point, [1000, 1000]."""
    from hdsdp_tpu_torch.models import synthetic
    from hdsdp_tpu_torch.models.problem import SDPProblem
    from hdsdp_tpu_torch.solver import algo
    from hdsdp_tpu_torch.solver.params import Params

    ipm = algo.DualIPM(SDPProblem.from_sdpa(synthetic.maxcut_sdpa(n=1000, seed=0)),
                       Params(verbose=False), device=dev)
    ipm.set_start("infeas", False)
    if not ipm.check_is_interior(ipm.tau, ipm.y):
        ipm.reset_start()
        _require(ipm.check_is_interior(ipm.tau, ipm.y), "maxG51's start is not interior")
    return ipm.S[0][0]


def _dd_kernel_phase(torch, ddchol, dev):
    """K8 (the DD panel factor) against its plain version on the card, bit
    for bit, at B = 32, 64, 128 and 256, each on a well-conditioned SPD
    panel, an ill-conditioned one (cond 1e12), an indefinite one (both must
    fail ok alike) and one of wild scales (entries 1e-28..1e28, inside the
    f32 range ops/dd.py states), and at each B a fleet of those four
    against its four single launches; then the whole ddchol.factor of
    maxG51's 1024-padded S, card against host.  Times K8 at every B, its
    plain version and f64 cholesky of the same panel (CUDA events), and the
    whole factor against f64 cholesky.  Returns (worst max |diff|, times)."""
    import numpy as np

    from hdsdp_tpu_torch.ops import dd

    rng = np.random.default_rng(8)
    worst = 0.0

    def spd(b, cond):
        q, _ = np.linalg.qr(rng.standard_normal((b, b)))
        a = (q * np.logspace(0, -np.log10(cond), b)) @ q.T
        return 0.5 * (a + a.T)

    def kinds(b):
        d = np.logspace(-14, 14, b)
        return {
            "well-conditioned SPD": spd(b, 1e2) + np.eye(b),
            "ill-conditioned SPD (cond 1e12)": spd(b, 1e12),
            "indefinite": spd(b, 1e2) - 0.5 * np.eye(b),
            "wild scales (1e-28..1e28)": d[:, None] * (spd(b, 1e2) + np.eye(b)) * d[None, :],
        }

    def check(name, a64):
        nonlocal worst
        ph, pl = dd.from_f64(torch.as_tensor(a64, device=dev))
        n0 = ddchol.PANEL_LAUNCHES
        got = ddchol.panel_factor(ph, pl)
        _require(ddchol.PANEL_LAUNCHES == n0 + 1, f"K8 did not count one launch at {name}")
        want = ddchol.panel_factor_ref(ph, pl)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("Lh", "Ll", "Wh", "Wl")):
            if not _bits_same(g, w):
                bad = (g != w) & ~(g.isnan() & w.isnan())
                raise AssertionError(
                    f"K8 differs from panel_factor_ref at {name}, {what}: "
                    f"{int(bad.sum())} entries, max |diff| {_max_abs_diff(g, w)}")
            worst = max(worst, _max_abs_diff(g, w))
        ok_k = ddchol.ok(ddchol.DDFactor(got[0], got[1], got[2][..., None, :, :],
                                         got[3][..., None, :, :]))
        ok_p = ddchol.ok(ddchol.DDFactor(want[0], want[1], want[2][..., None, :, :],
                                         want[3][..., None, :, :]))
        _require(torch.equal(ok_k, ok_p), f"K8 and its plain version disagree on ok at {name}")
        return got, ok_k

    panels = {}
    for b in ddchol.KERNEL_BLOCKS:
        mats = panels[b] = kinds(b)
        for name, a in mats.items():
            _, ok_k = check(f"B = {b}, {name}", a)
            _require(bool(ok_k) == (name != "indefinite"),
                     f"ok is {bool(ok_k)} on the {name} panel at B = {b}")
        stack = np.stack(list(mats.values()))
        fleet_out, ok_f = check(f"B = {b}, a fleet of 4", stack)
        for i, a in enumerate(mats.values()):
            single = ddchol.panel_factor(*dd.from_f64(torch.as_tensor(a, device=dev)))
            _require(all(_bits_same(f[i], s) for f, s in zip(fleet_out, single)),
                     f"K8's fleet differs from its single launch at B = {b}, instance {i}")
        _require(ok_f.tolist() == [True, True, False, True], f"fleet ok {ok_f.tolist()} at B = {b}")
        print(f"[kernel] K8 dd_panel [{b},{b}]: the four panels ({', '.join(mats)}) == "
              f"panel_factor_ref bit for bit (L, W, signed zeros, NaN where NaN), ok alike; a "
              f"fleet of the four [4,{b},{b}] in one launch == the 4 single launches, ok "
              f"{ok_f.tolist()}", flush=True)

    # -- the whole DD factor of maxG51's S: card == host, bit for bit ---------
    S = _maxg51_start_s(torch, dev)
    f_card = ddchol.factor(S)
    f_host = ddchol.factor(S.cpu())
    _require(all(_bits_same(x.cpu(), y) for x, y in zip(f_card, f_host)),
             "ddchol.factor of maxG51's S differs between the card and the host")
    L = dd.to_f64(f_card.lh, f_card.ll)[:1000, :1000]
    rel = float((L @ L.T - S).abs().max() / S.abs().max())
    _require(bool(ddchol.ok(f_card)) and rel < 1e-12, f"maxG51's DD factor: rel {rel}")
    print(f"[kernel] ddchol.factor of maxG51's S (1000 -> 1024, 4 panels): card == host "
          f"plain versions bit for bit; |L L^T - S| / |S| = {rel:.3e}", flush=True)

    # K8 and f64 cholesky of the well-conditioned panel at every B; the
    # rest at B = 256, the main path's panel
    by_b = {}
    for b in ddchol.KERNEL_BLOCKS:
        a = panels[b]["well-conditioned SPD"]
        ph, pl = dd.from_f64(torch.as_tensor(a, device=dev))
        a64 = torch.as_tensor(a, device=dev)
        by_b[b] = {"ms": _device_ms(lambda: ddchol.panel_factor(ph, pl), reps=10),
                   "bound_ms": _panel_bound_ms(b)[0],
                   "cholesky_f64_ms": _device_ms(lambda: torch.linalg.cholesky_ex(a64), reps=10)}
    b = ddchol.KERNEL_BLOCKS[-1]  # 256, the main path's panel
    ph, pl = dd.from_f64(torch.as_tensor(panels[b]["well-conditioned SPD"], device=dev))
    stack = np.stack(list(panels[b].values()))
    fh, fl = dd.from_f64(torch.as_tensor(stack, device=dev))
    singles = [dd.from_f64(torch.as_tensor(x, device=dev)) for x in stack]
    t = {
        "k8": by_b[b]["ms"],
        "k8_plain": _time_ms(lambda: ddchol.panel_factor_ref(ph, pl), reps=2, warmup=1),
        "cholesky_f64": by_b[b]["cholesky_f64_ms"],
        "k8_bound": _panel_bound_ms(b),
        "k8_fleet": _device_ms(lambda: ddchol.panel_factor(fh, fl), reps=5),
        "k8_fleet_singles": _device_ms(lambda: [ddchol.panel_factor(*x) for x in singles],
                                       reps=5),
        "k8_fleet_bound": _panel_bound_ms(b, 4),
        "factor": _device_ms(lambda: ddchol.factor(S), reps=5),
        "factor_eager": _time_ms(lambda: ddchol.factor(S), reps=5, warmup=1),
        "factor_cholesky_f64": _device_ms(lambda: torch.linalg.cholesky_ex(S), reps=10),
        "k8_by_block": by_b,
    }
    smi = _smi_line()
    print(f"[kernel] K8's bound: {_panel_ops(b)} f32 operations that L and W need "
          f"({_panel_ops(b) / b ** 3:.2f} B^3; the trailing lower triangle and W's lower "
          f"triangle) at {PEAK_F32_OPS / 1e12} T/s (no FMA: half of {PEAK_F32_FLOPS / 1e12} "
          f"TFLOP/s), against {6 * 4 * b * b} bytes at {PEAK_BYTES_S / 1e12} TB/s", flush=True)
    print(f"[kernel] K8 [{b},{b}] device ms (CUDA events around a graph of 10 calls) on {smi}: "
          f"{t['k8']:.4f} (bound {t['k8_bound'][0]:.5f} by {t['k8_bound'][1]}; plain, eager: "
          f"{t['k8_plain']:.2f}; "
          f"yardstick f64 torch.linalg.cholesky of the same panel {t['cholesky_f64']:.4f}); "
          f"fleet of 4 {t['k8_fleet']:.4f} (4 single launches {t['k8_fleet_singles']:.4f}, "
          f"bound {t['k8_fleet_bound'][0]:.5f})", flush=True)
    print("[kernel] K8 by B, device ms (bound, f64 cholesky): " + "; ".join(
        f"{bb}: {v['ms']:.4f} ({v['bound_ms']:.5f}, {v['cholesky_f64_ms']:.4f})"
        for bb, v in by_b.items()), flush=True)
    print(f"[kernel] ddchol.factor of maxG51's S: {t['factor']:.3f} ms on the device, "
          f"{t['factor_eager']:.3f} ms eager; f64 torch.linalg.cholesky of the same S "
          f"{t['factor_cholesky_f64']:.3f} ms ({t['factor'] / t['factor_cholesky_f64']:.1f}x)",
          flush=True)
    return worst, t


# The [dd] phase's solves of maxG51 (maxcut_sdpa(n=1000, seed=0)) and their
# references: (status, iterations, d_obj, DIMACS max) of the JAX package's
# run with the same overrides on the card's host CPU, `JAX_PLATFORMS=cpu
# python tests/jax_reference.py maxG51 --fused auto --kw '{"cone_fp": "dd"}'`
# (a), `--fused false --kw '{"kkt_fp": "dd", "cone_fp": "dd"}'` (b), `--fused
# auto --kw '{"kkt_hp": "on"}'` (c); 475, 607 and 107 s, three at once on 8
# cores.  Held: status, d_obj 1e-7 relative, DIMACS max <= 1e-6; the
# iterations are printed.
DD_SOLVES = {
    "a": ({"cone_fp": "dd"}, ("PRIMAL_DUAL_OPTIMAL", 34, -261.42702231327434, 5.2351653001697896e-09)),
    "b": ({"fused": False, "kkt_fp": "dd", "cone_fp": "dd"},
          ("PRIMAL_DUAL_OPTIMAL", 33, -261.4270223132649, 3.951510001920758e-09)),
    "c": ({"kkt_hp": "on"}, ("PRIMAL_DUAL_OPTIMAL", 34, -261.42702231344566, 4.456649268410192e-09)),
}
DD_FLEET = 4  # (d): 4 x maxcut_sdpa(n=1000, seed=s) with cone_fp="dd"
DD_PATHS = {"a": "dd (a) maxG51 cone_fp=dd, fused", "b": "dd (b) maxG51 kkt_fp=cone_fp=dd, host loop",
            "c": "dd (c) maxG51 kkt_hp=on, fused", "d": "dd (d) 4 x maxG51 cone_fp=dd, fleet"}


def _dd_launches(hpmm, ddchol, k0=None):
    """(K8, K1, K1s) launches, or their growth since k0."""
    now = (ddchol.PANEL_LAUNCHES, hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES)
    return now if k0 is None else tuple(a - b for a, b in zip(now, k0))


def _dd_phase(torch, solve_sdpa_file, instances, hpmm, default_wall, tmp):
    """The double-single path on maxG51 through the entry points: (a) the
    default (fused "iter") path with cone_fp="dd", every cone factor and
    interior check through ops.ddchol; (b) the host loop with kkt_fp and
    cone_fp "dd", the Schur factor by ddchol and f64 refinement; (c)
    kkt_hp="on", U = S^-1 through ddchol.spd_inverse_from_f64_tri; (d) a
    fleet of 4 with cone_fp="dd", each member held to its solo solve.
    (a)-(c) are held to DD_SOLVES; K1 and K1s must launch in all four and
    K8 where the path factors with it: (a), (b), (d).  (c) builds its DD
    factor from the f64 factor the cone system already has
    (ddchol.factor_from_f64_tri, the JAX route too), so it launches no K8.
    Returns each path's (K8, K1, K1s) launches, counted from 0 around it."""
    from hdsdp_tpu_torch import solve_batch
    from hdsdp_tpu_torch.models import synthetic
    from hdsdp_tpu_torch.models.problem import SDPProblem
    from hdsdp_tpu_torch.ops import ddchol
    from hdsdp_tpu_torch.solver.solver import HDSDPSolver

    path = os.path.join(tmp, "maxG51.dat-s")
    instances.write_instance("maxG51", path)
    launches = {}
    for key, (over, (ref_status, ref_iters, ref_d_obj, ref_dimacs)) in DD_SOLVES.items():
        torch.cuda.synchronize()
        ddchol.PANEL_LAUNCHES = hpmm.KERNEL_LAUNCHES = hpmm.SLICE_LAUNCHES = 0
        t0 = time.perf_counter()
        r = solve_sdpa_file(path, device="cuda", verbose=False, **over)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[key] = _dd_launches(hpmm, ddchol)
        rel_d = abs(r.d_obj - ref_d_obj) / abs(ref_d_obj)
        dmax = float(abs(r.dimacs).max())
        print(json.dumps({
            "dd_phase": key, "instance": "maxG51", "overrides": over, "fused": r.stats.get("fused"),
            "status": r.status, "iterations": r.n_iters, "jax_iterations": ref_iters,
            "d_obj": r.d_obj, "jax_d_obj": ref_d_obj, "rel_d_obj_err": rel_d,
            "dimacs_max": dmax, "jax_dimacs_max": ref_dimacs, "wall_s": wall,
            "default_fused_wall_s": default_wall,
            "launches_k8_k1_k1s": launches[key], "device": r.device,
        }), flush=True)
        k8, k1, k1s = launches[key]
        checks = {
            "status": r.status == ref_status,
            "d_obj": rel_d <= 1e-7,
            "dimacs": dmax <= 1e-6,
            "path": r.stats.get("fused") == ("iter" if over.get("fused", "auto") else False),
            "k8": k8 > 0 if key != "c" else k8 == 0,
            "k1_k1s": k1 > 0 and k1s > 0,
            "device": r.device.startswith("cuda"),
        }
        if not all(checks.values()):
            raise AssertionError(f"[dd] ({key}) checks failed: {checks}")

    # -- (d): a fleet with cone_fp="dd" against its members' solo solves -------
    probs = [SDPProblem.from_sdpa(synthetic.maxcut_sdpa(n=1000, seed=s))
             for s in range(DD_FLEET)]
    solos, solo_walls = [], []
    for prob in probs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solos.append(HDSDPSolver(prob, device="cuda", verbose=False, cone_fp="dd").optimize())
        torch.cuda.synchronize()
        solo_walls.append(time.perf_counter() - t0)
    ddchol.PANEL_LAUNCHES = hpmm.KERNEL_LAUNCHES = hpmm.SLICE_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = solve_batch(probs, device="cuda", verbose=False, cone_fp="dd")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["d"] = _dd_launches(hpmm, ddchol)
    acct = rs[0].stats["fleet"]
    rel = [abs(a.d_obj - b.d_obj) / abs(b.d_obj) for a, b in zip(rs, solos)]
    dmax = [float(abs(r.dimacs).max()) for r in rs]
    print(json.dumps({
        "dd_phase": "d", "fleet": f"{DD_FLEET} x maxcut_sdpa(n=1000, seed=0..{DD_FLEET - 1})",
        "overrides": {"cone_fp": "dd"}, "status": [r.status for r in rs],
        "batch_solo": [r.stats["batch_solo"] for r in rs],
        "iterations": [r.n_iters for r in rs], "solo_iterations": [r.n_iters for r in solos],
        "d_obj": [r.d_obj for r in rs], "rel_d_obj_to_solo": rel, "dimacs_max": dmax,
        "wall_s": wall,
        "solo_walls_s": solo_walls, "fleet_kernel_launches_k1_k1s_k8": acct["kernel_launches"],
        "launches_k8_k1_k1s": launches["d"],
    }), flush=True)
    checks = {
        "in_fleet": all(r.stats["batch_solo"] == 0 for r in rs),
        "status": all(r.status == s.status == "PRIMAL_DUAL_OPTIMAL" for r, s in zip(rs, solos)),
        "d_obj": all(x <= 1e-7 for x in rel),
        "dimacs": all(x <= 1e-6 for x in dmax),
        "solo_to_a": abs(solos[0].d_obj - DD_SOLVES["a"][1][2]) / abs(DD_SOLVES["a"][1][2]) <= 1e-7,
        "kernels": all(x > 0 for x in acct["kernel_launches"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"[dd] (d) checks failed: {checks}")
    return launches


def _batch_phase(torch, hpmm, profiled_solve):
    """solve_batch on the card: three fleets at the sizes users batch,
    each instance held to its own solo (default, fused) solve of this run.
    Returns the gpp fleet's (K1, K1s) launches, counted from 0 around its
    solve_batch."""
    from types import SimpleNamespace

    from hdsdp_tpu_torch import solve_batch
    from hdsdp_tpu_torch.models import synthetic
    from hdsdp_tpu_torch.models.problem import SDPProblem
    from hdsdp_tpu_torch.solver import batch as batch_mod
    from hdsdp_tpu_torch.solver.solver import HDSDPSolver

    class NoSolo:
        """Stands in for the solo re-solves in the profiled fleet call, so
        that its counts are the fleet's own work."""

        def __init__(self, *args, **kwargs):
            pass

        def optimize(self):
            return SimpleNamespace(stats={})

    gpp_launches = None
    for name, gen, kwargs, n_f, over in BATCH_FLEETS:
        probs = [SDPProblem.from_sdpa(getattr(synthetic, gen)(seed=s, **kwargs))
                 for s in range(n_f)]

        def solo(prob):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = HDSDPSolver(prob, device="cuda", verbose=False, **over).optimize()
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        def fleet():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = solve_batch(probs, device="cuda", verbose=False, **over)
            torch.cuda.synchronize()
            return rs, time.perf_counter() - t0

        solo(probs[0])  # warm-up: libraries and kernels loaded
        # peaks are counted above what the earlier phases left allocated
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        solos, solo_walls, solo_launches = [], [], [0, 0]
        for prob in probs:
            k0, s0 = hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES
            r, wall = solo(prob)
            solo_launches[0] += hpmm.KERNEL_LAUNCHES - k0
            solo_launches[1] += hpmm.SLICE_LAUNCHES - s0
            solos.append(r)
            solo_walls.append(wall)
        solo_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        hpmm.KERNEL_LAUNCHES = hpmm.SLICE_LAUNCHES = 0
        rs, wall = fleet()
        launches = (hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        acct = rs[0].stats["fleet"]
        fleet_stats = {"fused": "batch", "fused_host_reads": acct["host_reads"]}
        saved, batch_mod.HDSDPSolver = batch_mod.HDSDPSolver, NoSolo
        try:
            _, _, fc = profiled_solve(lambda: (lambda out: (SimpleNamespace(
                n_iters=acct["iterations"], stats=fleet_stats), out[1]))(fleet()))
        finally:
            batch_mod.HDSDPSolver = saved
        _, _, sc = profiled_solve(lambda: solo(probs[0]))
        rel = [abs(a.d_obj - b.d_obj) / abs(b.d_obj) for a, b in zip(rs, solos)]
        dmax = [float(abs(r.dimacs).max()) for r in rs]
        solo_dmax = [float(abs(r.dimacs).max()) for r in solos]
        print(json.dumps({
            "batch": name, "fleet_size": n_f, "generator": f"{gen}({kwargs}, seed=0..{n_f - 1})",
            "overrides": over, "m": int(rs[0].y.shape[0]),
            "status": [r.status for r in rs], "solo_status": [r.status for r in solos],
            "iterations": [r.n_iters for r in rs], "solo_iterations": [r.n_iters for r in solos],
            "fleet_iterations": acct["iterations"],
            "batch_solo": sum(r.stats["batch_solo"] for r in rs),
            "batch_exits": [r.stats.get("batch_exit") for r in rs],
            "solo_phase_exits": [r.stats.get("fused_exit") for r in solos],
            "rel_d_obj_to_solo": rel, "dimacs_max": dmax, "solo_dimacs_max": solo_dmax,
            "wall_s": wall, "solo_walls_sum_s": sum(solo_walls), "solo_walls_s": solo_walls,
            "peak_device_bytes": peak, "solo_peak_device_bytes": solo_peak,
            "fleet": acct, "hpmm_launches_whole_call": launches,
            "solo_hpmm_launches_sum": solo_launches,
            "per_fleet_iteration": fc["per_iteration"], "per_solo_iteration": sc["per_iteration"],
            "profiled_wall_s_fleet_without_resolves_solo": [fc["wall_s"], sc["wall_s"]],
            "device_busy_share_fleet_solo": [fc["device_busy_share_of_profiled_wall"],
                                             sc["device_busy_share_of_profiled_wall"]],
            "top_kernels_fleet_solo": [fc["top_kernels_ms"], sc["top_kernels_ms"]],
        }), flush=True)
        # a member the fleet finished is held to its solo solve (status,
        # d_obj 1e-7, DIMACS 1e-6); the maxcut fleets must finish every
        # member.  A member whose phase B ends otherwise than OPTIMAL is
        # re-solved solo, as the JAX module does: gpp's solo solves
        # themselves end phase B on the small-step rule (NUMERICAL) and are
        # made PRIMAL_DUAL_OPTIMAL by their DIMACS check, so every gpp
        # member is re-solved (in the JAX package's fleet too,
        # tests/jax_reference.py gpp500 --batch 4).  There the fleet must
        # end each member's phase B as its solo solve ends it (phase and
        # status; the iteration moves with the batched kernels' rounding),
        # and the re-solve must repeat this run's solo solve bit for bit.
        in_fleet = [r.stats["batch_solo"] == 0 for r in rs]

        def same_end(r, s):
            return r.stats["batch_exit"].split(" at ")[0] == s.stats["fused_exit"].split(" at ")[0]

        checks = {
            "finished_in_fleet": (all(in_fleet) if over.get("kkt_hp") != "on" else
                                  all(f or same_end(r, s) for f, r, s in zip(in_fleet, rs, solos))),
            "status": all(r.status == s.status == "PRIMAL_DUAL_OPTIMAL"
                          for r, s in zip(rs, solos)),
            "d_obj": all(x <= 1e-7 if f else x == 0.0 for x, f in zip(rel, in_fleet)),
            "dimacs": all(d <= 1e-6 if f else d == sd
                          for d, sd, f in zip(dmax, solo_dmax, in_fleet)),
            "device": all(r.device.startswith("cuda") for r in rs),
        }
        if over.get("kkt_hp") == "on":
            k1, k1s, _ = acct["kernel_launches"]
            gpp_launches = (k1, k1s)
            builds = acct["kkt_builds"]
            # one K1 launch per product for the whole fleet: gpp's slot
            # bucket (r = 1, no dense part) has two products per KKT build
            # with M (FU and the one pair), one without ("corr"); K1s slices
            # both operands of each
            products = 2 * (builds.get("inf", 0) + builds.get("hsd", 0)) + builds.get("corr", 0)
            checks["one_launch_per_fleet_product"] = 0 < k1 == products and k1s == 2 * k1
            # a fleet of one runs the batched bodies with single-instance
            # linear algebra: its phase B must end exactly where the solo
            # solve's does, iteration included
            one = solve_batch(probs[:1], device="cuda", verbose=False, **over)[0]
            one_end = (one.stats.get("batch_exit")
                       or f"phase B: PRIMAL_DUAL_OPTIMAL at iteration {one.n_iters}")
            checks["fleet_of_one_ends_as_solo"] = (one_end == solos[0].stats["fused_exit"]
                                                   and one.d_obj == solos[0].d_obj)
            print(f"[batch] {name}: the fleet's own K1 launches {k1} = one per fleet product "
                  f"({products}), K1s {k1s}; members finished in the fleet {sum(in_fleet)} of "
                  f"{n_f}; phase B ends, fleet / solo: {[r.stats.get('batch_exit') for r in rs]} / "
                  f"{[s.stats['fused_exit'] for s in solos]}; a fleet of one of seed 0: "
                  f"{one_end} / {solos[0].stats['fused_exit']}", flush=True)
        else:
            checks["no_own_kernels"] = launches == (0, 0)
        if over.get("kkt_mp") == "on":
            # the mixed-precision fleet: each member's f64 ladder its own,
            # every member held to the JAX package's fleet too
            rel_jax = [abs(r.d_obj - ref[2]) / abs(ref[2]) for r, ref in zip(rs, BATCH_MP_REFS)]
            print(json.dumps({
                "batch_mp": name, "jax_status": [ref[0] for ref in BATCH_MP_REFS],
                "jax_iterations": [ref[1] for ref in BATCH_MP_REFS],
                "rel_d_obj_to_jax_fleet": rel_jax,
                "mp_f64_factors_of_mp_factors": [(r.stats.get("mp_f64_factors"),
                                                  r.stats.get("mp_factors")) for r in rs],
                "solo_mp_f64_factors_of_mp_factors": [(s_.stats.get("mp_f64_factors"),
                                                       s_.stats.get("mp_factors")) for s_ in solos],
            }), flush=True)
            checks["jax_status"] = all(r.status == ref[0] for r, ref in zip(rs, BATCH_MP_REFS))
            checks["jax_d_obj"] = all(x <= 1e-7 for x in rel_jax)
            checks["mp_backend"] = all(r.stats.get("mp_factors", 0) > 0 for r in rs + solos)
        if not all(checks.values()):
            raise AssertionError(f"the {name} fleet: checks failed: {checks}")

    # the mixed-shape fleet of tests/test_batch.py is refused
    mixed = [SDPProblem.from_sdpa(synthetic.random_sdpa(m=16, block_dims=[8], seed=1)),
             SDPProblem.from_sdpa(synthetic.random_sdpa(m=20, block_dims=[8], seed=2))]
    try:
        solve_batch(mixed, device="cuda")
    except ValueError as e:
        print(f"[batch] mixed shapes (random m = 16 and m = 20): ValueError ({e})", flush=True)
    else:
        raise AssertionError("solve_batch took a fleet of mixed shapes")
    return gpp_launches


def _f32_host_check(torch, path, over, ckpt):
    """The port's DIMACS check on the host at the end state a float32
    solve on the card wrote to ``ckpt``: (status, errors)."""
    from hdsdp_tpu_torch import SDPProblem, read_sdpa
    from hdsdp_tpu_torch.solver import algo, dimacs
    from hdsdp_tpu_torch.solver.params import Params
    from hdsdp_tpu_torch.utils.checkpoint import load_checkpoint

    params = Params(**dict(over, fused=False, dtype="float32", verbose=False))
    ipm = algo.DualIPM(SDPProblem.from_sdpa(read_sdpa(path)), params, torch.device("cpu"))
    algo.load_state(ipm, load_checkpoint(ckpt))
    errs = dimacs.check_solution(ipm)
    return ipm.status, errs


def _f32_phase(torch, solve_sdpa_file, instances, tmp):
    """dtype="float32" on the host loop: maxG51, control11 and theta6
    through HDSDPSolver with fused=False, each beside its float64
    host-loop solve through solve_sdpa_file (peak device memory and wall
    of both), held to the JAX package's float32 host loop (F32_REFS,
    F32_DIMACS_JAX); the port's check on the host at the card's end state
    must reach the reference's status too (F32_CARD_CHECK_REFUSES).  The
    fused driver refuses float32.  Returns {name: (peak bytes f32, f64,
    wall f32, f64)}."""
    import numpy as np

    from hdsdp_tpu_torch import HDSDPSolver, SDPProblem, read_sdpa

    out = {}
    for name in F32_REFS:
        path = os.path.join(tmp, f"{name}.dat-s")
        ckpt = os.path.join(tmp, f"{name}_f32_end.npz")
        over = instances.write_instance(name, path)
        runs = {}
        for dt in ("float64", "float32"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if dt == "float64":
                res = solve_sdpa_file(path, device="cuda", verbose=False, fused=False, **over)
            else:
                res = HDSDPSolver(SDPProblem.from_sdpa(read_sdpa(path)), device="cuda",
                                  verbose=False, fused=False, dtype=dt,
                                  **over).optimize(checkpoint_to=ckpt)
            torch.cuda.synchronize()
            runs[dt] = (res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base)
        r, wall, peak = runs["float32"]
        r64, wall64, peak64 = runs["float64"]
        ref = F32_REFS[name]
        rel = abs(r.d_obj - ref[2]) / abs(ref[2])
        dmax = float(abs(r.dimacs).max())
        bound = max(1e-6, 10.0 * F32_DIMACS_JAX[name])
        host_status, host_errs = _f32_host_check(torch, path, over, ckpt)
        host_dmax = float(np.max(np.abs(host_errs)))
        print(json.dumps({
            "f32": name, "overrides": dict(over, fused=False, dtype="float32"),
            "status": r.status, "jax_f32_status": ref[0], "iterations": r.n_iters,
            "jax_f32_iterations": ref[1], "f64_iterations": r64.n_iters, "d_obj": r.d_obj,
            "jax_f32_d_obj": ref[2], "rel_d_obj_err": rel, "f64_d_obj": r64.d_obj,
            "rel_to_f64_d_obj": abs(r.d_obj - r64.d_obj) / abs(r64.d_obj),
            "dimacs_max": dmax, "jax_f32_dimacs_max": ref[3], "dimacs_bound": bound,
            "host_check_status": host_status, "host_check_dimacs_max": host_dmax,
            "peak_device_bytes": peak, "f64_peak_device_bytes": peak64,
            "wall_s": wall, "f64_wall_s": wall64, "y_dtype": str(r.y.dtype),
            "fused": r.stats.get("fused"), "device": r.device,
        }), flush=True)
        # the card's check may refuse both of control11's makers (see
        # F32_CARD_CHECK_REFUSES): its errors are then all 1
        refused = (name in F32_CARD_CHECK_REFUSES and r.status == "NUMERICAL"
                   and bool((r.dimacs == 1.0).all()))
        checks = {
            "status": r.status == ref[0] or refused,
            "d_obj": rel <= F32_D_OBJ_REL,
            "dimacs": dmax <= bound or refused,
            "host_check_status": host_status == ref[0],
            "host_check_dimacs": host_dmax <= bound,
            "host_loop": r.stats.get("fused") is False,
            "device": r.device.startswith("cuda"),
        }
        if not all(checks.values()):
            raise AssertionError(f"[f32] {name}: checks failed: {checks}")
        out[name] = (peak, peak64, wall, wall64)
    try:
        solve_sdpa_file(path, device="cuda", verbose=False, dtype="float32")
    except NotImplementedError as e:
        print(f"[f32] the fused driver refuses float32: {e}", flush=True)
    else:
        raise AssertionError("[f32] the fused driver ran dtype='float32'")
    return out


def _family_phase(torch, solve_sdpa_file, instances, hpmm):
    """The five SDPLIB-size instances beyond gpp500 through the default
    path; raises unless each meets its holds.  Returns their objectives."""
    d_objs = {}
    for name, (ref_iters, ref_d_obj) in FAMILY_REFS.items():
        runs = []
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, name + ".dat-s")
            overrides = instances.write_instance(name, path)
            for _ in range(2 if name in FAMILY_TWICE else 1):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                k0 = hpmm.KERNEL_LAUNCHES + hpmm.SLICE_LAUNCHES
                t0 = time.perf_counter()
                r = solve_sdpa_file(path, device="cuda", verbose=False, fused=False,
                                    **overrides)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                runs.append(r)
                st = r.stats
                rel_d = abs(r.d_obj - ref_d_obj) / abs(ref_d_obj)
                print(json.dumps({
                    "family": name, "m": int(r.y.shape[0]), "status": r.status,
                    "iterations": r.n_iters, "jax_iterations": ref_iters,
                    "d_obj": r.d_obj, "p_obj": r.p_obj, "rel_d_obj_err": rel_d,
                    "dimacs_max": float(abs(r.dimacs).max()), "wall_s": wall,
                    "peak_device_bytes": torch.cuda.max_memory_allocated(),
                    "n_kkt": st["n_kkt"], "n_factor": st["n_factor"], "n_solve": st["n_solve"],
                    "cg_n_factor": st.get("cg_n_factor"), "cg_n_solve": st.get("cg_n_solve"),
                    "psdp_runs": st.get("psdp_runs", 0), "psdp_iters": st.get("psdp_iters", 0),
                    "own_kernel_launches": hpmm.KERNEL_LAUNCHES + hpmm.SLICE_LAUNCHES - k0,
                    "device": r.device,
                }), flush=True)
                checks = {
                    "status": r.status == "PRIMAL_DUAL_OPTIMAL",
                    "dimacs": float(abs(r.dimacs).max()) <= 1e-6,
                    "d_obj": rel_d <= 1e-7,
                    "device": r.device.startswith("cuda"),
                    "cg": name not in FAMILY_CG
                    or 0 < st.get("cg_n_factor", 0) < st.get("cg_n_solve", 0),
                    "psdp": name not in FAMILY_PSDP or st.get("psdp_runs", 0) > 0,
                }
                if not all(checks.values()):
                    raise AssertionError(f"{name} checks failed: {checks}")
        if len(runs) == 2:
            a, b = runs
            same = (a.d_obj == b.d_obj and a.p_obj == b.p_obj and a.n_iters == b.n_iters
                    and bool((torch.as_tensor(a.y) == torch.as_tensor(b.y)).all()))
            print(f"[families] {name} solved twice: d_obj {a.d_obj!r} / {b.d_obj!r}, "
                  f"iterations {a.n_iters} / {b.n_iters}, y bit-equal: {same}", flush=True)
            if not same:
                raise AssertionError(f"{name}: two solves in one process differ")
        d_objs[name] = runs[0].d_obj
    return d_objs


def _fused_phase(torch, solve_sdpa_file, instances, hpmm, profiled_solve, tmp):
    """The six SDPLIB-size instances through the default path, which
    picks the fused phase bodies ("iter"); raises unless each meets its
    holds.  Returns gpp500's (K1, K1s) launches, counted from 0 around
    that solve, each instance's ``_bits`` and its wall."""
    host_refs = dict(FAMILY_REFS, gpp500=(REF_ITERS, REF_D_OBJ))
    gpp500_launches = None
    bits = {}  # name -> _bits of the first default-path solve
    walls = {}  # name -> wall s of the last default-path solve
    for name, (ref_iters, ref_d_obj) in FUSED_REFS.items():
        path = os.path.join(tmp, name + ".dat-s")
        overrides = instances.write_instance(name, path)

        def solve(**over):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = solve_sdpa_file(path, device="cuda", verbose=False, **dict(overrides, **over))
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        runs = []
        for _ in range(2 if name in FUSED_TWICE else 1):
            hpmm.KERNEL_LAUNCHES = hpmm.SLICE_LAUNCHES = 0
            r, wall = solve()
            launches = (hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES)
            runs.append(r)
            peak = torch.cuda.max_memory_allocated()
        bits[name] = _bits(runs[0])
        walls[name] = wall
        if name == "gpp500":
            gpp500_launches = launches
        _, _, fc = profiled_solve(solve)
        _, _, hc = profiled_solve(lambda: solve(fused=False))
        st = r.stats
        rel_d = abs(r.d_obj - ref_d_obj) / abs(ref_d_obj)
        print(json.dumps({
            "fused_phase": name, "m": int(r.y.shape[0]), "fused": st.get("fused"),
            "status": r.status, "iterations": r.n_iters,
            "jax_fused_iterations": ref_iters,
            "host_loop_iterations": hc["iterations"],
            "jax_host_loop_iterations": host_refs[name][0],
            "d_obj": r.d_obj, "p_obj": r.p_obj, "rel_d_obj_err": rel_d, "dimacs_max": float(abs(r.dimacs).max()), "wall_s": wall,
            "peak_device_bytes": peak, "psdp_runs": st.get("psdp_runs", 0),
            "hpmm_pairs_launches": launches[0], "hpmm_slice_launches": launches[1],
            "per_iteration_fused": fc["per_iteration"],
            "per_iteration_host_loop": hc["per_iteration"],
            "profiled_wall_s_fused_host_loop": [fc["wall_s"], hc["wall_s"]],
            "device_busy_share_fused_host_loop": [fc["device_busy_share_of_profiled_wall"],
                                                  hc["device_busy_share_of_profiled_wall"]],
            "device": r.device,
        }), flush=True)
        checks = {
            "iter": st.get("fused") == "iter" and fc["fused"] == "iter"
            and hc["fused"] is False,
            "status": r.status == "PRIMAL_DUAL_OPTIMAL",
            "dimacs": float(abs(r.dimacs).max()) <= 1e-6,
            "d_obj": rel_d <= 1e-7,
            "device": r.device.startswith("cuda"),
            "own_kernels": (launches[0] > 0 and launches[1] == 2 * launches[0])
            if name == "gpp500" else launches == (0, 0),
            "psdp": name not in FUSED_PSDP or st.get("psdp_runs", 0) > 0,
        }
        if not all(checks.values()):
            raise AssertionError(f"{name} on the fused path: checks failed: {checks}")
        if len(runs) == 2:
            a, b = runs
            same = (a.d_obj == b.d_obj and a.p_obj == b.p_obj and a.n_iters == b.n_iters
                    and bool((torch.as_tensor(a.y) == torch.as_tensor(b.y)).all()))
            print(f"[fused] {name} solved twice: d_obj {a.d_obj!r} / {b.d_obj!r}, iterations "
                  f"{a.n_iters} / {b.n_iters}, y bit-equal: {same}", flush=True)
            if not same:
                raise AssertionError(f"{name}: two fused solves in one process differ")

    # -- "phase" at gpp n = 40: card against host, "phase" against "iter" ---
    from hdsdp_tpu_torch.io.sdpa import write_sdpa
    from hdsdp_tpu_torch.models.synthetic import gpp_sdpa

    path = os.path.join(tmp, "gpp40.dat-s")
    write_sdpa(gpp_sdpa(n=40, seed=0), path)
    rg = solve_sdpa_file(path, device="cuda", verbose=False)
    rc = solve_sdpa_file(path, device="cpu", verbose=False)
    ri = solve_sdpa_file(path, device="cuda", verbose=False, fused="iter")
    rel_small = abs(rg.d_obj - rc.d_obj) / abs(rc.d_obj)
    same = (rg.d_obj == ri.d_obj and rg.p_obj == ri.p_obj and rg.n_iters == ri.n_iters
            and bool((torch.as_tensor(rg.y) == torch.as_tensor(ri.y)).all()))
    print(f"[fused] gpp40 default ({rg.stats['fused']}) card vs host: {rg.status}/{rc.status} "
          f"iterations {rg.n_iters}/{rc.n_iters} rel d_obj diff {rel_small:.3e}; card "
          f"\"phase\" vs \"iter\": d_obj {rg.d_obj!r} / {ri.d_obj!r}, iterations "
          f"{rg.n_iters} / {ri.n_iters}, y bit-equal: {same}", flush=True)
    if not (rg.stats["fused"] == rc.stats["fused"] == "phase" and ri.stats["fused"] == "iter"
            and rg.status == rc.status == "PRIMAL_DUAL_OPTIMAL"
            and abs(rg.n_iters - rc.n_iters) <= 1 and rel_small <= 1e-7 and same):
        raise AssertionError("gpp40 on the fused path: card/host or phase/iter disagree")
    return gpp500_launches, bits, walls


def _operator_phase(torch, solve_sdpa_file, instances, hpmm, dense_d_obj, tmp):
    """Operator mode at m = 25,001 through the default path, its dense
    reference, and two more instances forced matrix-free; ``dense_d_obj``
    holds the objectives of the dense solves of the earlier phases, ``tmp``
    is a directory for the instances' files.  Raises unless every hold is
    met."""
    from hdsdp_tpu_torch.solver.algo import DualIPM

    written = {}  # name -> (path, the instance's overrides)
    builds = []  # (kkt_free, M is None) after every KKT build of the dual solve
    plain_build = DualIPM.build_kkt

    def spying_build(self, kind):
        out = plain_build(self, kind)
        builds.append((self.kkt_free, out.M is None))
        return out

    def solve(name, **over):
        if name not in written:  # each instance's file is written once
            path = os.path.join(tmp, name + ".dat-s")
            written[name] = (path, instances.write_instance(name, path))
        path, overrides = written[name]
        overrides = dict(overrides, **over)
        del builds[:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0, s0 = hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES
        DualIPM.build_kkt = spying_build
        t0 = time.perf_counter()
        try:
            r = solve_sdpa_file(path, device="cuda", verbose=False, **overrides)
        finally:
            DualIPM.build_kkt = plain_build
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = r.stats
        line = {
            "operator_phase": name, "overrides": overrides, "m": int(r.y.shape[0]),
            "status": r.status, "iterations": r.n_iters, "d_obj": r.d_obj, "p_obj": r.p_obj,
            "dimacs_max": float(abs(r.dimacs).max()), "wall_s": wall,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "kkt_builds": len(builds),
            "kkt_builds_matrix_free": sum(free and no_m for free, no_m in builds),
            "n_solve": st["n_solve"], "opcg_iters": st.get("opcg_iters", 0),
            "op_pc_builds": st.get("op_pc_builds", 0),
            "op_escalations": st.get("op_escalations", 0),
            "cg_n_factor": st.get("cg_n_factor"), "psdp_runs": st.get("psdp_runs", 0),
            "psdp_iters": st.get("psdp_iters", 0), "psdp_op_runs": st.get("psdp_op_runs", 0),
            "hpmm_pairs_launches": hpmm.KERNEL_LAUNCHES - k0,
            "hpmm_slice_launches": hpmm.SLICE_LAUNCHES - s0, "fused": st.get("fused"),
            "device": r.device,
        }
        print(json.dumps(line), flush=True)
        return r, line

    def matrix_free(line):
        return (line["kkt_builds"] > 0 and line["kkt_builds_matrix_free"] == line["kkt_builds"]
                and line["opcg_iters"] > 0)

    # -- m = 25,001 with default parameters: kkt_mode="auto" engages it ----
    name = "theta-m25001"
    r, line = solve(name)
    checks = {
        "status": r.status == "PRIMAL_DUAL_OPTIMAL",
        "matrix_free": matrix_free(line),  # kkt_free and no dense M at every KKT build
        "op_pc_builds": line["op_pc_builds"] >= 1,
        "op_escalations": line["op_escalations"] == 0,  # tier 3 would allocate the 5 GB M
        "psdp_matrix_free": line["psdp_op_runs"] == line["psdp_runs"],
        "host_loop": r.stats["fused"] is False,  # operator mode: never fused
        "dimacs": line["dimacs_max"] <= OPERATOR_DIMACS_BOUND,
        "d_obj": abs(r.d_obj - OPERATOR_JAX_REF[1]) <= 1e-6 * abs(OPERATOR_JAX_REF[1]),
        "own_kernels": line["hpmm_pairs_launches"] == 0 and line["hpmm_slice_launches"] == 0,
        "device": r.device.startswith("cuda"),
    }
    if not all(checks.values()):
        raise AssertionError(f"{name} in operator mode: checks failed: {checks}")
    # a second reference: the port's dense path on the same file (a 5.0 GB
    # f64 M, AdaptiveCG, PSDP's row-chunked dense build).  Both runs leave
    # PSDP through its flatten exit, after different numbers of iterations,
    # at relative gaps of about 1e-5, and each late iteration moves d_obj by
    # about 1e-6 relative: the two objectives are held to 1e-5.
    rd, dline = solve(name, kkt_mode="dense", fused=False)
    rel = abs(r.d_obj - rd.d_obj) / abs(rd.d_obj)
    print(f"[operator] {name}: d_obj {r.d_obj!r}, relative to the JAX package's CPU run "
          f"({OPERATOR_JAX_REF[1]!r}, {OPERATOR_JAX_REF[0]} iterations) "
          f"{abs(r.d_obj - OPERATOR_JAX_REF[1]) / abs(OPERATOR_JAX_REF[1]):.3e}, to the port's "
          f"dense path ({rd.d_obj!r}) {rel:.3e}; iterations {r.n_iters} / {rd.n_iters} dense; "
          f"DIMACS max {line['dimacs_max']:.3e} / {dline['dimacs_max']:.3e}; the JAX package's "
          f"older TPU record for this generator call: {OPERATOR_JAX_RECORD_D_OBJ!r}", flush=True)
    if not (rd.status == "PRIMAL_DUAL_OPTIMAL" and dline["kkt_builds_matrix_free"] == 0
            and dline["opcg_iters"] == 0 and rel <= 1e-5):
        raise AssertionError(f"{name}: operator mode against the dense path: {line} / {dline}")

    # -- the diag shortcut and the generic slot-major row build, forced ----
    # (the generic bucket on random-m1000, whose dense solve comes first:
    # CG cannot carry gpp500, see utils/instances.py)
    rd, _ = solve("random-m1000", fused=False)
    dense_d_obj = dict(dense_d_obj, **{"random-m1000": rd.d_obj})
    for name in ("maxG51", "random-m1000"):
        r, line = solve(name, kkt_mode="free")
        rel = abs(r.d_obj - dense_d_obj[name]) / abs(dense_d_obj[name])
        print(f"[operator] {name} kkt_mode=free: d_obj {r.d_obj!r} against its dense solve "
              f"{dense_d_obj[name]!r}, relative difference {rel:.3e}", flush=True)
        if not (r.status == "PRIMAL_DUAL_OPTIMAL" and matrix_free(line) and rel <= 1e-6
                and line["dimacs_max"] <= 1e-6):
            raise AssertionError(f"{name} under kkt_mode=free: {line}")

    # -- applying the preconditioner at m = 25,001: the explicit inverse
    # (two f32 products with Linv, what the solver does) against two
    # triangular solves with L, on 3 right-hand sides ------------------------
    m, k = 25001, 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    Ms = torch.randn((m, 64), generator=gen, device="cuda", dtype=torch.float32)
    Ms = Ms @ Ms.T / 64.0
    Ms.diagonal().add_(1.0)  # SPD, well conditioned
    L = torch.linalg.cholesky(Ms)
    del Ms
    Linv = torch.linalg.solve_triangular(
        L, torch.eye(m, device="cuda", dtype=torch.float32), upper=False)
    R = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.float32)
    via_inv = Linv.T @ (Linv @ R)
    via_solve = torch.linalg.solve_triangular(
        L.T, torch.linalg.solve_triangular(L, R, upper=False), upper=True)
    diff = float((via_inv - via_solve).abs().max() / via_solve.abs().max())
    t_inv = _time_ms(lambda: Linv.T @ (Linv @ R), reps=10)
    t_solve = _time_ms(lambda: torch.linalg.solve_triangular(
        L.T, torch.linalg.solve_triangular(L, R, upper=False), upper=True), reps=10)
    print(f"[operator] applying the f32 preconditioner at m = {m}, {k} right-hand sides: "
          f"two products with Linv {t_inv:.3f} ms, two triangular solves with L "
          f"{t_solve:.3f} ms (relative difference of the results {diff:.2e}); the bytes of "
          f"L or Linv read twice at {PEAK_BYTES_S / 1e12} TB/s: "
          f"{1e3 * 2 * 4 * m * m / PEAK_BYTES_S:.3f} ms", flush=True)
    _require(diff < 1e-3, "the two preconditioner applications disagree")


def _bits(r) -> dict:
    """What two solves of one instance must share bit for bit."""
    import hashlib

    import numpy as np

    y = np.ascontiguousarray(r.y)
    return {"status": r.status, "iterations": r.n_iters, "d_obj": repr(r.d_obj),
            "p_obj": repr(r.p_obj), "y_sha256": hashlib.sha256(y.tobytes()).hexdigest()}


def _solve_once(name: str) -> int:
    """Solve a named instance through the default path on the card and
    print its _bits as one JSON line (the subprocess of the thread check)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from hdsdp_tpu_torch.solver.solver import solve_sdpa_file
    from hdsdp_tpu_torch.utils import instances

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name + ".dat-s")
        overrides = instances.write_instance(name, path)
        r = solve_sdpa_file(path, device="cuda", verbose=False, **overrides)
    print(json.dumps(_bits(r)))
    return 0


def _api_phase(torch, solve_sdpa_file, instances, hpmm, fused_bits, tmp):
    """The LP solver, the CLI's .mps path, checkpoint and resume, the KKT
    cross-check, the native reader and the thread-count repair on the card;
    raises unless every hold is met."""
    import numpy as np

    from hdsdp_tpu_torch.io.sdpa import read_sdpa
    from hdsdp_tpu_torch.models.problem import SDPProblem
    from hdsdp_tpu_torch.models.synthetic import random_sdpa
    from hdsdp_tpu_torch.solver.lpsolve import solve_mps_file
    from hdsdp_tpu_torch.solver.solver import HDSDPSolver
    from hdsdp_tpu_torch.utils.kktcheck import kkt_cross_validate

    # -- the LP through an MPS file, twice ---------------------------------
    path = os.path.join(tmp, "lp1800.mps")
    instances.write_lp_instance("lp1800", path)
    for ratio in (None, 0.0):
        over = {} if ratio is None else {"primal_switch_ratio": ratio}
        ref_iters, ref_method, ref_p, ref_d = LP_JAX_REFS[0.0 if ratio == 0.0 else 1e30]
        hpmm.KERNEL_LAUNCHES = hpmm.SLICE_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve_mps_file(path, verbose=False, **over)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gap = abs(r.p_obj - r.d_obj) / (abs(r.p_obj) + abs(r.d_obj) + 1.0)
        rel_p, rel_d = abs(r.p_obj - ref_p) / abs(ref_p), abs(r.d_obj - ref_d) / abs(ref_d)
        print(json.dumps({
            "api": "lp1800", "primal_switch_ratio": "default (50.0)" if ratio is None else ratio,
            "status": r.status, "iterations": r.n_iters, "jax_iterations": ref_iters,
            "last_method": r.last_method, "jax_last_method": ref_method,
            "p_obj": r.p_obj, "d_obj": r.d_obj, "rel_gap": gap,
            "rel_p_obj_to_jax": rel_p, "rel_d_obj_to_jax": rel_d, "wall_s": wall,
            "factor_solve_ratio": r.factor_solve_ratio,
            "own_kernel_launches": hpmm.KERNEL_LAUNCHES + hpmm.SLICE_LAUNCHES,
        }), flush=True)
        if not (r.status == "PRIMAL_DUAL_OPTIMAL" and gap <= 1e-7 and rel_p <= 1e-6
                and rel_d <= 1e-6):
            raise AssertionError(f"lp1800 (primal_switch_ratio {ratio}): {r.status}, gap "
                                 f"{gap:.3e}, to JAX {rel_p:.3e} / {rel_d:.3e}")

    # -- the CLI's .mps path on the card -----------------------------------
    mps = os.path.join(tmp, "ranged.mps")
    with open(mps, "w") as f:
        f.write(RANGED_MPS)
    out = subprocess.run([sys.executable, "-m", "hdsdp_tpu_torch", mps, "--json", "--quiet"],
                         capture_output=True, text=True, timeout=300)
    summary = json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 else {}
    print(f"[api] python -m hdsdp_tpu_torch ranged.mps --json: rc {out.returncode} "
          f"{summary}", flush=True)
    if not (out.returncode == 0 and summary.get("device") == "cuda"
            and abs(summary["pObj"] - RANGED_OBJ) <= 1e-6 * abs(RANGED_OBJ)):
        raise AssertionError(f"the CLI's .mps path: rc {out.returncode}\n{out.stderr[-3000:]}")

    # -- checkpoint and resume on maxG51 -----------------------------------
    sdpa = os.path.join(tmp, "maxG51.dat-s")
    overrides = instances.write_instance("maxG51", sdpa)
    prob = SDPProblem.from_sdpa(read_sdpa(sdpa))
    ck = os.path.join(tmp, "maxG51.npz")
    r1 = HDSDPSolver(prob, verbose=False, **overrides).optimize(checkpoint_to=ck)
    r2 = HDSDPSolver(prob, verbose=False, **overrides).optimize(resume_from=ck)
    rel = abs(r2.d_obj - r1.d_obj) / abs(r1.d_obj)
    print(f"[api] maxG51 checkpoint_to then resume_from: {r1.status} / {r2.status}, "
          f"iterations {r1.n_iters} / {r2.n_iters}, d_obj {r1.d_obj!r} / {r2.d_obj!r} "
          f"(relative {rel:.3e}), driver {r1.stats['fused']} / {r2.stats['fused']}", flush=True)
    if not (r1.status == r2.status == "PRIMAL_DUAL_OPTIMAL" and rel <= 1e-8
            and r2.n_iters <= r1.n_iters + 2):
        raise AssertionError("maxG51: the resumed solve does not meet its holds")

    # -- the KKT cross-check on the card -----------------------------------
    kprob = SDPProblem.from_sdpa(random_sdpa(m=200, block_dims=[60, 40], n_lp=20, seed=0))
    errs = kkt_cross_validate(kprob)
    print(f"[api] kkt_cross_validate(random_sdpa(m=200, [60, 40], n_lp=20)) on the card: "
          f"{errs}", flush=True)
    _require(max(errs.values()) < 1e-8, "the KKT cross-check exceeds 1e-8")

    # -- the native reader on theta-m25001's file --------------------------
    big = os.path.join(tmp, "theta-m25001.dat-s")
    instances.write_instance("theta-m25001", big)
    read_sdpa(big)  # the library is built by now; one warm-up read
    t0 = time.perf_counter()
    native = read_sdpa(big)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(big) as f:
        python = read_sdpa(f)
    t_python = time.perf_counter() - t0
    same = (native.m == python.m and native.block_dims == python.block_dims
            and native.nnz == python.nnz and np.array_equal(native.b, python.b)
            and all(np.array_equal(getattr(x, k), getattr(y, k)) and
                    getattr(x, k).dtype == getattr(y, k).dtype
                    for x, y in zip(native.blocks, python.blocks)
                    for k in ("con", "row", "col", "val")))
    print(f"[api] theta-m25001's file ({os.path.getsize(big)} bytes, {native.nnz} entries): "
          f"native reader {t_native:.4f} s, Python parser {t_python:.4f} s, saved "
          f"{t_python - t_native:.4f} s; arrays bitwise equal: {same}", flush=True)
    _require(same, "the native reader and the Python parser disagree")

    # -- the thread-count repair: theta6 and gpp500 under 2 threads --------
    env = dict(os.environ, OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    for name in THREADS_REPEAT:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--solve-once", name],
                             capture_output=True, text=True, timeout=600, env=env)
        got = json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 else {}
        print(f"[api] {name} under OMP_NUM_THREADS=2: {got}; the fused phase's solve: "
              f"{fused_bits[name]}", flush=True)
        if got != fused_bits[name]:
            raise AssertionError(f"{name} under 2 threads differs from the full-thread solve "
                                 f"(rc {out.returncode})\n{out.stderr[-3000:]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import hdsdp_tpu_torch  # noqa: F401  (sets the no-TF32 policy)
    from hdsdp_tpu_torch.io.sdpa import write_sdpa
    from hdsdp_tpu_torch.models.synthetic import gpp_sdpa
    from hdsdp_tpu_torch.ops import cuda_build, ddchol, hpmm, hpmm_cases
    from hdsdp_tpu_torch.solver.solver import solve_sdpa_file
    from hdsdp_tpu_torch.utils import instances
    from hdsdp_tpu_torch.utils.stage_profile import profiled_solve

    dev = torch.device("cuda", 0)
    smi = _smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {smi}", flush=True)

    # -- build --------------------------------------------------------
    t0 = time.perf_counter()
    records = cuda_build.build_all()
    print(f"[build] {len(records)} kernels in {time.perf_counter() - t0:.2f} s, "
          f"one nvcc each, started together", flush=True)
    for name, rec in records.items():
        cuda_build.load(name)
        print(f"[build] {name}: nvcc {rec['seconds']:.2f} s -> {rec['path'].name}", flush=True)
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # -- kernels vs plain versions, single and with a fleet axis ----------
    max_err, max_err_slice, times = _kernel_phase(hpmm, hpmm_cases, dev)
    f_err, f_err_slice, fleet_times = _fleet_kernel_phase(hpmm, dev)
    max_err, max_err_slice = max(max_err, f_err), max(max_err_slice, f_err_slice)
    dd_err, dd_times = _dd_kernel_phase(torch, ddchol, dev)

    launches, slice_launches, wall, gpp_d_obj = _slice_phase(torch, hpmm, solve_sdpa_file,
                                                             write_sdpa, gpp_sdpa)

    # -- the other families at SDPLIB size, default parameters -------------
    dense_d_obj = _family_phase(torch, solve_sdpa_file, instances, hpmm)

    # -- the default path: the fused phase bodies -------------------------
    with tempfile.TemporaryDirectory() as tmp:
        fused_launches, fused_bits, fused_walls = _fused_phase(torch, solve_sdpa_file, instances, hpmm,
                                                  profiled_solve, tmp)

    # -- operator mode: m = 25,001 by default, two instances forced --------
    with tempfile.TemporaryDirectory() as tmp:
        _operator_phase(torch, solve_sdpa_file, instances, hpmm, dense_d_obj, tmp)

    # -- the LP solver, the CLI, checkpoints, the KKT check, the native
    # reader and the thread-count repair ----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        _api_phase(torch, solve_sdpa_file, instances, hpmm, fused_bits, tmp)

    # -- fleets of same-shape instances: solve_batch -----------------------
    batch_launches = _batch_phase(torch, hpmm, profiled_solve)

    # -- the double-single path: maxG51 through ddchol, K8 and K1/K1s -------
    with tempfile.TemporaryDirectory() as tmp:
        dd_launches = _dd_phase(torch, solve_sdpa_file, instances, hpmm,
                                fused_walls["maxG51"], tmp)

    # -- the mesh path: one NCCL rank here, then four gloo ranks ----------
    mesh1 = _mesh1_phase(instances, dict(dense_d_obj, gpp500=gpp_d_obj))
    mesh1_launches = mesh1[("gpp500", "")]["launches"]
    mesh4_launches, mesh4_dd = _mesh4_phase(instances, mesh1)
    mesh_dd = {"mesh1 maxG51 cone_fp=dd (NCCL, 1 rank), by rank":
               mesh1[("maxG51", "cone_dd")]["launches_by_rank"],
               "mesh4 maxG51 cone_fp=dd (gloo, 4 ranks), by rank": mesh4_dd}

    # -- dtype="float32" on the host loop ----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        _f32_phase(torch, solve_sdpa_file, instances, tmp)

    _summary(torch, times, fleet_times, max_err, max_err_slice, wall,
             (launches, slice_launches), fused_launches, batch_launches,
             mesh1_launches, mesh4_launches, dd_err, dd_times, dd_launches, mesh_dd)
    return 0


def _slice_phase(torch, hpmm, solve_sdpa_file, write_sdpa, gpp_sdpa):
    """gpp500 on the host loop with the Ozaki Schur assembly, counting the
    kernels' launches from 0, and a small solve on the card against the
    host; returns (K1 launches, K1s launches, wall s)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpp500.dat-s")
        write_sdpa(gpp_sdpa(n=500, seed=0), path)
        torch.cuda.synchronize()
        hpmm.KERNEL_LAUNCHES = 0
        hpmm.SLICE_LAUNCHES = 0
        t0 = time.perf_counter()
        r = solve_sdpa_file(path, device="cuda", kkt_hp="on", verbose=False, fused=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = hpmm.KERNEL_LAUNCHES
        slice_launches = hpmm.SLICE_LAUNCHES
    dmax = float(abs(r.dimacs).max())
    rel_d = abs(r.d_obj - REF_D_OBJ) / abs(REF_D_OBJ)
    print(f"[slice] gpp500 kkt_hp=on: {r.status} iters {r.n_iters} "
          f"d_obj {r.d_obj!r} p_obj {r.p_obj!r} rel d_obj err {rel_d:.3e} "
          f"DIMACS max {dmax:.3e} wall {wall:.2f} s stats {r.stats} "
          f"hpmm_pairs launches {launches} hpmm_slice launches {slice_launches} "
          f"on {r.device}; JAX reference {REF_ITERS} iters", flush=True)
    checks = {
        "status": r.status == "PRIMAL_DUAL_OPTIMAL",
        "d_obj": rel_d <= 1e-7,
        "dimacs": dmax <= 1e-6,
        "launches": launches > 0 and slice_launches == 2 * launches,
        "device": r.device.startswith("cuda"),
        "y": r.y.shape == (501,) and bool(torch.isfinite(torch.as_tensor(r.y)).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: {checks}")

    # -- a small solve on the card against the same solve on the host ----
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpp40.dat-s")
        write_sdpa(gpp_sdpa(n=40, seed=0), path)
        rg = solve_sdpa_file(path, device="cuda", kkt_hp="on", verbose=False, fused=False)
        rc = solve_sdpa_file(path, device="cpu", kkt_hp="on", verbose=False, fused=False)
    rel_small = abs(rg.d_obj - rc.d_obj) / abs(rc.d_obj)
    print(f"[slice] gpp40 card vs host: {rg.status}/{rc.status} iters "
          f"{rg.n_iters}/{rc.n_iters} rel d_obj diff {rel_small:.3e}", flush=True)
    if not (rg.status == rc.status == "PRIMAL_DUAL_OPTIMAL"
            and abs(rg.n_iters - rc.n_iters) <= 1 and rel_small <= 1e-7):
        raise AssertionError("small solve on the card disagrees with the host")
    return launches, slice_launches, wall, r.d_obj


def _mesh_line(phase, name, kw, ranks, r, ref, solo_d_obj=None, mesh1_d_obj=None):
    """Print one mesh solve as JSON beside its JAX mesh reference."""
    st = r["stats"]
    it = max(r["iterations"], 1)
    print(json.dumps({
        "phase": phase, "instance": name, "overrides": MESH_KW[kw], "ranks": ranks,
        "device": r["device"], "cones": r["cones"], "status": r["status"],
        "jax_mesh_status": ref[0], "iterations": r["iterations"], "jax_mesh_iterations": ref[1],
        "d_obj": r["d_obj"], "jax_mesh_d_obj": ref[2],
        "rel_d_obj_err": abs(r["d_obj"] - ref[2]) / abs(ref[2]),
        "log_rows_rel_err": _rows_err(r["log_rows"], MESH_ROWS[kw]) if kw in MESH_ROWS else None,
        "dimacs_max": float(abs(r["dimacs"]).max()), "jax_mesh_dimacs_max": ref[3],
        "solo_host_loop_d_obj": solo_d_obj, "mesh1_d_obj": mesh1_d_obj,
        "every_rank_same_y_and_obj": bool(r["same_y"] and r["same_obj"]),
        "wall_s": r["wall_s"], "peak_device_bytes_rank0": r["peak_bytes"],
        "factor": {k: st.get(k, 0) for k in ("shchol_factors", "shcg_factors", "shcg_iters",
                                             "opcg_iters", "n_factor", "n_solve")},
        "psdp_runs": st.get("psdp_runs", 0), "psdp_ended_the_solve": r["psdp"],
        "kkt_free": r["kkt_free"],
        "hpmm_launches_rank0": r["launches"], "k8_launches_rank0": r["k8_launches"],
        "launches_k1_k1s_k8_by_rank": r["launches_by_rank"],
        "collectives_per_iteration": {k: v / it for k, v in sorted(r["counts"].items())},
    }), flush=True)


def _rows_err(rows, ref):
    """The largest relative difference of d_obj and mu between the first
    len(ref) log rows and the reference's; inf where the rows' (method,
    iteration) differ or run short."""
    if len(rows) < len(ref) or any(tuple(a[:2]) != tuple(b[:2]) for a, b in zip(rows, ref)):
        return float("inf")
    return max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(rows, ref) for k in (2, 3))


def _mesh_holds(r, ref, name, kw=""):
    """The holds every mesh solve meets against its JAX mesh reference;
    the gpp500 witnesses (kw "exact", "exact_off") their log rows in place
    of the DIMACS max."""
    dmax = float(abs(r["dimacs"]).max())
    tol = F32_D_OBJ_REL if kw == "f32" else 1e-7
    holds = {
        "status": r["status"] == ref[0],
        "d_obj": abs(r["d_obj"] - ref[2]) <= tol * abs(ref[2]),
        "device": r["device"].startswith("cuda"),
        "same_on_every_rank": bool(r["same_y"] and r["same_obj"]),
        "host_loop": r["stats"]["fused"] is False,
    }
    if kw in MESH_ROWS:
        holds["log_rows"] = _rows_err(r["log_rows"], MESH_ROWS[kw]) <= MESH_ROWS_TOL
    elif kw == "f32":
        holds["dimacs"] = dmax <= min(1e-2, max(1e-6, 10.0 * F32_MESH_DIMACS_JAX))
    else:
        holds["dimacs"] = dmax <= max(1e-6, 10.0 * ref[3])
    if name == "gpp500":
        hp = MESH_KW[kw].get("kkt_hp", "on") == "on"
        k1, k1s = r["launches"]
        holds["k1_k1s"] = (k1 > 0 and k1s == 2 * k1) if hp else k1 == k1s == 0
    if kw == "cone_dd":
        # the DD cone factor on every rank: K8 for the panels, K1s/K1 for
        # the strips
        holds["k8_k1_k1s_every_rank"] = all(min(row) > 0 for row in r["launches_by_rank"])
    return holds


def _mesh1_phase(instances, solo_d_obj):
    """The mesh path on a real NCCL group of one rank (this process); the
    group is destroyed after.  Returns {(name, kw): solve record}."""
    import numpy as np
    import torch.distributed as dist

    from hdsdp_tpu_torch.parallel import run
    from hdsdp_tpu_torch.parallel.mesh import free_port, init_world, make_mesh

    init_world(0, 1, "nccl", free_port(), timeout=MESH_TIMEOUT)
    out = {}
    try:
        mesh = make_mesh("cuda:0")
        print(f"[mesh1] {mesh}", flush=True)
        for name, kw, repeat in (("maxG51", "", 2), ("control11", "", 1), ("gpp500", "", 1),
                                 ("gpp500", "exact", 1), ("gpp500", "exact_off", 1),
                                 ("theta6", "", 1), ("maxG51", "free", 1),
                                 ("maxG51", "cone_dd", 1), ("maxG51", "kkt_dd", 1),
                                 ("maxG51", "f32", 1)):
            gen, kwargs, over = instances.INSTANCES[name]
            res = run.solve(mesh, gen, kwargs, dict(over, **MESH_KW[kw]), repeat=repeat)
            runs = res if repeat > 1 else [res]
            ref = MESH_REFS[(name, kw, 1)]
            for r in runs:
                _mesh_line("mesh1", name, kw, 1, r, ref,
                           solo_d_obj=None if kw.startswith("exact") else solo_d_obj[name])
                checks = _mesh_holds(r, ref, name, kw)
                st = r["stats"]
                if name == "maxG51" and not kw:
                    checks["distributed_cholesky"] = st.get("shchol_factors", 0) > 0
                if name == "control11":
                    checks["slot_partitioned"] = (r["cones"] == "ShardedConeSystem"
                                                  and r["counts"].get("reduce_scatter", 0) > 0)
                if name == "theta6":
                    checks["row_sharded_cg"] = (st.get("shcg_factors", 0) > 0
                                                and st.get("shcg_iters", 0) > 0)
                    checks["psdp"] = st.get("psdp_runs", 0) > 0
                if kw == "free":
                    checks["operator"] = r["kkt_free"] and st.get("opcg_iters", 0) > 0
                if kw == "kkt_dd":
                    # inert on a mesh: the plain line's iterates, bit for bit
                    plain = out[("maxG51", "")]
                    checks["same_as_plain"] = (r["d_obj"] == plain["d_obj"]
                                               and r["iterations"] == plain["iterations"]
                                               and np.array_equal(r["y"], plain["y"]))
                    checks["no_k8"] = r["k8_launches"] == 0
                if kw == "f32":
                    plain = out[("maxG51", "")]
                    print(f"[mesh1] maxG51 dtype=float32: peak device bytes {r['peak_bytes']} "
                          f"(float64 {plain['peak_bytes']}), wall {r['wall_s']:.3f} s (float64 "
                          f"{plain['wall_s']:.3f} s), iterations {r['iterations']} (JAX "
                          f"{ref[1]}, float64 {plain['iterations']})", flush=True)
                if not all(checks.values()):
                    raise AssertionError(f"[mesh1] {name} {kw}: checks failed: {checks}")
            if repeat > 1:
                a, b = runs
                same = (a["d_obj"] == b["d_obj"] and a["iterations"] == b["iterations"]
                        and np.array_equal(a["y"], b["y"]))
                print(f"[mesh1] {name} solved twice: d_obj {a['d_obj']!r} / {b['d_obj']!r}, "
                      f"iterations {a['iterations']} / {b['iterations']}, y bit-equal: {same}",
                      flush=True)
                if not same:
                    raise AssertionError(f"[mesh1] {name}: two solves differ")
            out[(name, kw)] = runs[0]
    finally:
        dist.destroy_process_group()
    return out


def _mesh4_phase(instances, mesh1):
    """Four ranks on the one card over gloo: six solves (three instances,
    the two gpp500 witnesses and maxG51 with cone_fp="dd") and the dry run
    in one spawned world.  Returns gpp500's rank-0 (K1, K1s) launches and
    the cone_fp="dd" solve's (K1, K1s, K8) launches of every rank."""
    from hdsdp_tpu_torch.parallel import run
    from hdsdp_tpu_torch.parallel.mesh import spawn

    solves = (("maxG51", ""), ("control11", ""), ("gpp500", ""), ("gpp500", "exact"),
              ("gpp500", "exact_off"), ("maxG51", "cone_dd"))
    todo = []
    for name, kw in solves:
        gen, kwargs, over = instances.INSTANCES[name]
        todo.append(("solve", dict(gen=gen, kwargs=kwargs, overrides=dict(over, **MESH_KW[kw]))))
    todo.append(("dryrun", {}))
    t0 = time.perf_counter()
    res = spawn(run.calls, 4, "gloo", "cuda:0", todo, timeout=MESH_TIMEOUT)
    print(f"[mesh4] world of 4 gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} s for "
          f"{len(solves)} solves and the dry run, start-up included", flush=True)
    for (name, kw), r in zip(solves, res):
        ref = MESH_REFS[(name, kw, 4)]
        _mesh_line("mesh4", name, kw, 4, r, ref, mesh1_d_obj=mesh1[(name, kw)]["d_obj"])
        if kw == "cone_dd":
            dd_launches = r["launches_by_rank"]
        checks = _mesh_holds(r, ref, name, kw)
        checks["ranks"] = r["size"] == 4
        if name == "control11":
            checks["slot_partitioned"] = r["cones"] == "ShardedConeSystem"
        if not all(checks.values()):
            raise AssertionError(f"[mesh4] {name}: checks failed: {checks}")
    dry = res[-1]
    print(f"[mesh4] dry run: {json.dumps(dry)}", flush=True)
    launches = res[solves.index(("gpp500", ""))]["launches"]
    if not (max(dry["row_sharded"]["rows_per_rank"]) < dry["row_sharded"]["m"]
            and max(dry["slot_sharded"]["rows_per_rank"]) < dry["slot_sharded"]["m"]):
        raise AssertionError("[mesh4] a rank of the dry run held every row of M")
    return launches, dd_launches


def _summary(torch, times, fleet_times, max_err, max_err_slice, wall, slice_launches,
             fused_launches, batch_launches, mesh1_launches, mesh4_launches, dd_err, dd_times,
             dd_launches, mesh_dd):
    """The kernel table line, the card's line and the contract line."""
    launches, slice_launches = slice_launches
    # K1 at the pair shape; K1s as the mean of the four operand launches of
    # the main path's two products (FU: A and a row-major B; pair: A and B
    # as a transposed view), its plain version and bound likewise; each
    # max_abs_err is the worst difference met in the kernel phase
    tf, tp = times["FU"], times["pair"]
    tfr, tr = times["FU_rows"], times["pair_rows"]
    kernels = [{
        "name": "hpmm_pairs",
        "route": "cuda",
        "source": "hdsdp_tpu_torch/csrc/hpmm_pairs.cu",
        "replaces": "hdsdp_tpu/ops/hpmm.py:162",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": tp["pairs_f64"],
        "plain_ms": tp["pairs_plain"],
        "bound_ms": tp["pairs_bound"][0],
        "bound_by": tp["pairs_bound"][1],
        "library_ms": tp["matmul"],
        # the fleet form at the gpp fleet's pair shape, and the launches of
        # each path that reaches the kernel (counted from 0 around it)
        "fleet": BATCH_KERNEL_FLEET,
        "fleet_ms": fleet_times["pair"]["pairs_f64"],
        "fleet_plain_ms": fleet_times["pair"]["pairs_plain"],
        "fleet_bound_ms": fleet_times["pair"]["pairs_bound"][0],
        "fleet_library_ms": fleet_times["pair"]["matmul"],
        "launches_by_path": {"slice (host loop)": launches, "fused": fused_launches[0],
                             "batch (gpp fleet)": batch_launches[0],
                             "mesh1 (gpp500, NCCL, 1 rank)": mesh1_launches[0],
                             "mesh4 (gpp500, gloo, rank 0 of 4)": mesh4_launches[0],
                             **{DD_PATHS[k]: v[1] for k, v in dd_launches.items()},
                             **{k: [row[0] for row in v] for k, v in mesh_dd.items()}},
        # one rank's rows of the pair product on a 4-rank mesh
        "row_shard": {"shape": "[126,500]@[500,501]", "ms": tr["pairs_f64"],
                      "plain_ms": tr["pairs_plain"], "bound_ms": tr["pairs_bound"][0],
                      "library_ms": tr["matmul"]},
    }, {
        "name": "hpmm_slice",
        "route": "cuda",
        "source": "hdsdp_tpu_torch/csrc/hpmm_slice.cu",
        "replaces": "hdsdp_tpu/ops/hpmm.py:297",
        "launches": slice_launches,
        "max_abs_err": max_err_slice,
        "ms": (tf["slice_a"] + tf["slice_b"] + tp["slice_a"] + tp["slice_b"]) / 4,
        "plain_ms": (tf["slice_a_plain"] + tf["slice_b_plain"]
                     + tp["slice_a_plain"] + tp["slice_b_plain"]) / 4,
        "bound_ms": (tf["slice_a_bound"][0] + tf["slice_b_bound"][0]
                     + tp["slice_a_bound"][0] + tp["slice_b_bound"][0]) / 4,
        "bound_by": tp["slice_a_bound"][1],
        "library_ms": None,
        "fleet": BATCH_KERNEL_FLEET,
        "fleet_ms": sum(t[k] for t in fleet_times.values() for k in ("slice_a", "slice_b")) / 4,
        "fleet_plain_ms": sum(t[k] for t in fleet_times.values()
                              for k in ("slice_a_plain", "slice_b_plain")) / 4,
        "fleet_bound_ms": sum(t[k][0] for t in fleet_times.values()
                              for k in ("slice_a_bound", "slice_b_bound")) / 4,
        "launches_by_path": {"slice (host loop)": slice_launches, "fused": fused_launches[1],
                             "batch (gpp fleet)": batch_launches[1],
                             "mesh1 (gpp500, NCCL, 1 rank)": mesh1_launches[1],
                             "mesh4 (gpp500, gloo, rank 0 of 4)": mesh4_launches[1],
                             **{DD_PATHS[k]: v[2] for k, v in dd_launches.items()},
                             **{k: [row[1] for row in v] for k, v in mesh_dd.items()}},
        # the four operand launches of one rank's two products on a 4-rank mesh
        "row_shard": {
            "shape": "[126,500] row blocks of FU and pair",
            "ms": (tfr["slice_a"] + tfr["slice_b"] + tr["slice_a"] + tr["slice_b"]) / 4,
            "plain_ms": (tfr["slice_a_plain"] + tfr["slice_b_plain"]
                         + tr["slice_a_plain"] + tr["slice_b_plain"]) / 4,
            "bound_ms": (tfr["slice_a_bound"][0] + tfr["slice_b_bound"][0]
                         + tr["slice_a_bound"][0] + tr["slice_b_bound"][0]) / 4},
    }, {
        # K8 at B = 256; its main path is (a), maxG51 with cone_fp="dd"
        "name": "dd_panel",
        "route": "cuda",
        "source": "hdsdp_tpu_torch/csrc/dd_panel.cu",
        "replaces": "hdsdp_tpu/ops/ddchol.py:44",
        "replaces_what": "_panel_factor, a lax.fori_loop XLA compiles (no Pallas kernel)",
        "launches": dd_launches["a"][0],
        "max_abs_err": dd_err,
        "ms": dd_times["k8"],
        "plain_ms": dd_times["k8_plain"],
        "bound_ms": dd_times["k8_bound"][0],
        "bound_by": dd_times["k8_bound"][1],
        "library_ms": dd_times["cholesky_f64"],
        "library_call": "torch.linalg.cholesky_ex of the same panel in f64, a yardstick",
        "ms_by_block": dd_times["k8_by_block"],
        "fleet": 4,
        "fleet_ms": dd_times["k8_fleet"],
        "fleet_singles_ms": dd_times["k8_fleet_singles"],
        "fleet_bound_ms": dd_times["k8_fleet_bound"][0],
        "launches_by_path": {**{DD_PATHS[k]: v[0] for k, v in dd_launches.items()},
                             **{k: [row[2] for row in v] for k, v in mesh_dd.items()}},
        "whole_factor_maxG51_ms": dd_times["factor"],
        "whole_factor_maxG51_cholesky_f64_ms": dd_times["factor_cholesky_f64"],
    }]
    print(f"[summary] whole hpmm at the pair shape: {tp['hpmm_device']:.4f} ms on the device, "
          f"{tp['hpmm']:.4f} ms per eager call; f64 torch.matmul {tp['matmul']:.4f} / "
          f"{tp['matmul_eager']:.4f} ms; gpp500 solve wall {wall:.3f} s; launches "
          f"(K1, K1s) of the host-loop gpp500 solve {(launches, slice_launches)}, of the fused "
          f"(default) one {fused_launches}, of the gpp fleet's own bodies {batch_launches}",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--solve-once"]:
        sys.exit(_solve_once(sys.argv[2]))
    sys.exit(main())
