"""Dual ratio test: max alpha with S + alpha * dS >= 0.

Equivalent to lambda_max of -L^{-1} dS L^{-T} (ref linalg/hdsdp_lanczos.c:
HLanczosSolve, and the matvec in hdsdp_conic_sdp.c:462-505): the step is
1 / lambda_max when positive, +inf otherwise.

Every test is batched over the leading axes of L (a fleet's instances
and their blocks alike): one ``eigh``/``eigvalsh`` call, and so one sync,
per call whatever the fleet's size.

  * exact_ratio_test: batched eigvalsh of the congruence;
  * lanczos_ratio_test(_adaptive): the reference's 30-dim Lanczos with its
    residual-based safeguard (ref hdsdp_lanczos.c:161-292).  The adaptive
    form stops early once the top Ritz pair converged; its convergence
    test is a host read every ``check_freq`` steps.

The Lanczos operator L^{-1} (-dS) L^{-T} is applied through an explicit
L^{-1}, formed once a test in the Lanczos's precision (``_inverse``:
diagonal blocks solved against I, the rest by block products, (1/3) n^3
multiply-adds); every matvec is then three matrix-vector products
(``_gemv_matvec``), with the sign folded into the one cast of dS.  Two
triangular solves a matvec, the reference's form, are a chain of n
dependent steps each and run far below the device's bandwidth: on an
H100 one test through L^{-1} takes 0.41-0.58 of their device time at
every order measured from 256 to 5000, and 0.10 for a fleet of 8 at
1000.  So one form serves every order and fleet size, and a
fleet member takes its solo solve's path.

On a non-finite matrix ``torch.linalg.eigh``/``eigvalsh`` raise where
``jnp.linalg.eigh`` returns NaN pairs; ``nan_safe=True`` gives the JAX
behaviour (the fused IPM bodies run on through a failed Schur factor, as
the JAX programs do).  On CUDA both calls wait for the device to check
their ``info``.
"""

from __future__ import annotations

import torch

from hdsdp_tpu_torch.ops.chol import congruence
from hdsdp_tpu_torch.utils import profile

INF_STEP = 1e30


def _eig(fn, T, nan_safe: bool):
    """fn(T) for fn in (eigh, eigvalsh); with nan_safe, a matrix holding
    a non-finite entry gets NaN outputs instead of an error.  On CUDA the
    call waits for the device to check ``info``: a host read."""
    profile.count("host_reads")
    if not nan_safe:
        return fn(T)
    bad = ~torch.isfinite(T).all(dim=-1).all(dim=-1)
    out = fn(torch.where(bad[..., None, None], 0.0, T))
    if isinstance(out, torch.Tensor):
        return torch.where(bad[..., None], torch.nan, out)
    w, Y = out
    return torch.where(bad[..., None], torch.nan, w), torch.where(bad[..., None, None], torch.nan, Y)


def exact_ratio_test(L: torch.Tensor, dS: torch.Tensor, nan_safe: bool = False) -> torch.Tensor:
    """Per-matrix max step, batched over leading dims. Returns [...]."""
    B = congruence(L, dS)
    B = 0.5 * (B + B.mT)
    lam_min = _eig(torch.linalg.eigvalsh, B, nan_safe)[..., 0]
    return torch.where(
        lam_min < 0.0, -1.0 / torch.clamp(lam_min, max=-1e-300), INF_STEP
    )


def _gemv_matvec(Linv, dSneg):
    """x -> Linv dSneg Linv^T x by three matrix-vector products, where
    Linv = L^{-1} and dSneg = -dS."""
    LinvT = Linv.mT

    def mv(x):
        return (Linv @ (dSneg @ (LinvT @ x[..., None])))[..., 0]

    return mv


def _lanczos_step(mv, V, T, i):
    """One reorthogonalized Lanczos step of the operator ``mv``: fills
    T[.., i, i], T[.., i+1, i], T[.., i, i+1] and V[.., i+1, :] in place."""
    vi = V[..., i, :]
    w = mv(vi)
    if i > 0:
        w = w - T[..., i, i - 1][..., None] * V[..., i - 1, :]
    alpha = torch.sum(w * vi, dim=-1)
    w = w - alpha[..., None] * vi
    # full reorthogonalization (cheap at k <= 30)
    proj = torch.einsum("...kn,...n->...k", V, w)
    w = w - torch.einsum("...k,...kn->...n", proj, V)
    beta = torch.linalg.vector_norm(w, dim=-1)
    vnext = torch.where(
        beta[..., None] > 0, w / torch.clamp(beta, min=1e-300)[..., None], w
    )
    T[..., i, i] = alpha
    T[..., i + 1, i] = beta
    T[..., i, i + 1] = beta
    V[..., i + 1, :] = vnext


def _bound_from_pairs(mv, Vk, w_eigs, Y):
    """Step bound 1/(lam1 + gamma) from the Ritz pairs (w_eigs, Y) of the
    tridiagonal over the basis Vk (ref hdsdp_lanczos.c:262-283); returns
    (step, M z1)."""
    k = Vk.shape[-2]
    lam1 = w_eigs[..., -1]
    lam2 = w_eigs[..., -2] if k > 1 else lam1

    y1 = Y[..., :, -1]
    z1 = torch.einsum("...kn,...k->...n", Vk, y1)
    Mz1 = mv(z1)
    r1 = torch.linalg.vector_norm(Mz1 - lam1[..., None] * z1, dim=-1)

    y2 = Y[..., :, -2] if k > 1 else y1
    z2 = torch.einsum("...kn,...k->...n", Vk, y2)
    Mz2 = mv(z2)
    r2 = torch.linalg.vector_norm(Mz2 - lam2[..., None] * z2, dim=-1)

    # residual-based bound on the eigengap (ref hdsdp_lanczos.c:262-267)
    gap = torch.clamp(lam1 - lam2 - r2, min=1e-16)
    gamma = torch.minimum(r1, r1 * r1 / gap)
    lam_bound = lam1 + gamma
    step = torch.where(
        lam_bound > 0.0, 1.0 / torch.clamp(lam_bound, min=1e-300), INF_STEP
    )
    return step, Mz1


def _start_basis(v0, k):
    batch = v0.shape[:-1]
    n = v0.shape[-1]
    V = torch.zeros(batch + (k + 1, n), dtype=v0.dtype, device=v0.device)
    V[..., 0, :] = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    T = torch.zeros(batch + (k + 1, k + 1), dtype=v0.dtype, device=v0.device)
    return V, T


def lanczos_ratio_test(mv, v0, krylov: int = 30, nan_safe: bool = False):
    """Fixed-depth batched Lanczos bound on the max step of the operator
    ``mv`` (conservative, like the reference).  Returns (steps [...], warm
    start for the next call)."""
    k = min(krylov, v0.shape[-1])
    V, T = _start_basis(v0, k)
    for i in range(k):
        _lanczos_step(mv, V, T, i)
    w_eigs, Y = _eig(torch.linalg.eigh, T[..., :k, :k], nan_safe)
    return _bound_from_pairs(mv, V[..., :k, :], w_eigs, Y)


def lanczos_ratio_test_adaptive(mv, v0, krylov: int = 30, check_freq: int = 3,
                                nan_safe: bool = False):
    """Early-exit Lanczos bound (ref hdsdp_lanczos.c:186-292): the same
    recurrence, stopped as soon as every matrix in the batch has a
    converged top Ritz pair, |beta_k * y1[k]| < 1e-4, checked every
    ``check_freq`` steps and at the last step (one host read each).

    The Ritz pairs are those of the leading block of T built so far.  The
    JAX package keeps a fixed shape for its compiler instead: it pads the
    rows not yet built with -1e12 on the diagonal, which decouples them.
    LAPACK splits such rows off, but cuSOLVER's f32 eigensolver does not
    always: on the padded matrix it returned top pairs wrong by percents
    (step bounds up to 8 % ABOVE the exact step at n = 3375, which stalled
    phase B) or gave up (n = 1000)."""
    k = min(krylov, v0.shape[-1])
    V, T = _start_basis(v0, k)
    i = 0
    while i < k:
        _lanczos_step(mv, V, T, i)
        i += 1
        if i % check_freq == 0 or i >= k:
            w_eigs, Y = _eig(torch.linalg.eigh, T[..., :i, :i], nan_safe)
            resi = torch.abs(T[..., i, i - 1] * Y[..., i - 1, -1])
            profile.count("host_reads")
            if bool(torch.max(resi) < 1e-04):  # host sync
                break
    return _bound_from_pairs(mv, V[..., :i, :], w_eigs, Y)


# exact-ratio threshold: below this dimension the batched eigh is used
AUTO_LANCZOS_DIM = 192
# _inverse solves diagonal blocks of at most this order against I in one
# batched call and builds the rest of L^{-1} from them by products
TRI_INV_LEAF = 512


def _block(A, r: int, c: int, nr: int, nc: int):
    """A view of the nr x nc block of A [..., n, n] at row r, column c."""
    return A[..., r:r + nr, c:c + nc]


def _diag_blocks(A, b: int, nb: int):
    """A view of the first nb diagonal b x b blocks of A [..., n, n], as
    [..., nb, b, b]."""
    st = A.stride()
    return A.as_strided(A.shape[:-2] + (nb, b, b),
                        st[:-2] + (b * (st[-2] + st[-1]), st[-2], st[-1]), A.storage_offset())


def _solve_against_eye(D):
    """D^{-1} for lower-triangular D [..., k, k] (contiguous), solved in
    place of the identity."""
    X = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device).expand_as(D).contiguous()
    return torch.linalg.solve_triangular(D, X, upper=False, out=X)


def _inverse(L, dt):
    """L^{-1} in dt for a lower-triangular L [..., n, n], with (1/3) n^3
    multiply-adds where one solve against I takes n^3.  The fewest equal
    diagonal blocks of order b <= TRI_INV_LEAF (and a last, shorter one
    where b does not divide n) are solved against I first, the equal ones
    in one batched call, which cuBLAS runs as one batched kernel beyond 8
    matrices; ``_tri_join`` builds the rest from them by products.  At
    most two n^2 matrices in dt are held at a time."""
    n = L.shape[-1]
    b = -(-n // -(-n // TRI_INV_LEAF))
    nb, r = n // b, n // b * b
    full = _solve_against_eye(_diag_blocks(L, b, nb).to(dt)) if nb else None
    last = _solve_against_eye(_block(L, r, r, n - r, n - r).to(dt)) if r < n else None
    X = torch.zeros(L.shape, dtype=dt, device=L.device)
    if full is not None:
        _diag_blocks(X, b, nb).copy_(full)
    if last is not None:
        _block(X, r, r, n - r, n - r).copy_(last)
    del full, last
    _tri_join(L.to(dt, copy=True).neg_(), X, 0, n, b)
    return X


def _tri_join(Ln, X, o: int, n: int, b: int):
    """inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B A^-1, C^-1]] for the
    order-n diagonal block at offset o, split at a multiple of b, down to
    X's inverted diagonal blocks of order <= b.  Ln = -L, so the sign
    comes with B; Ln's upper triangle, which nothing reads, holds each
    level's B A^-1 until C^-1 has taken it."""
    if n <= b:
        return
    h = b * (-(-n // b) // 2)
    m = n - h
    _tri_join(Ln, X, o, h, b)
    _tri_join(Ln, X, o + h, m, b)
    BAi = _block(Ln, o, o + h, h, m).mT
    torch.matmul(_block(Ln, o + h, o, m, h), _block(X, o, o, h, h), out=BAi)
    torch.matmul(_block(X, o + h, o + h, m, m), BAi, out=_block(X, o + h, o, m, h))


def _operator(L, dS, dt):
    """The Lanczos operator L^{-1} (-dS) L^{-T} in precision dt, by
    products with an L^{-1} formed here, whose copy of L in dt is dropped
    before dS's copy is made: the test holds two n^2 matrices in dt at a
    time."""
    profile.count("ratio_inverse")
    with profile.span("ratio_inverse"):
        Linv = _inverse(L, dt)
    return _gemv_matvec(Linv, dS.to(dt, copy=True).neg_())


def block_ratio(
    L: torch.Tensor,
    dS: torch.Tensor,
    mode: str = "auto",
    krylov: int = 30,
    use_f32: bool = True,
    v0=None,
    return_warm: bool = False,
    adaptive=None,
    nan_safe: bool = False,
):
    """Per-matrix max step for one block group, exact eigh vs Lanczos by
    mode and dimension.

    The Lanczos path runs in f32 (use_f32): the estimate only sizes a
    trial step, every accepted step is re-verified by an f64 interior
    check, and a 0.995 safety factor absorbs the reduced precision.  Its
    operator is applied through an L^{-1} formed once (``_operator``)."""
    n = L.shape[-1]
    if mode == "exact" or (mode == "auto" and n < AUTO_LANCZOS_DIM):
        steps = exact_ratio_test(L, dS, nan_safe)
        return (steps, None) if return_warm else steps
    dt = torch.float32 if use_f32 else L.dtype
    ar = torch.arange(n, device=L.device)
    if v0 is None:
        # deterministic start vector; later IPM iterations pass the
        # recorded Ritz image back in (ref hdsdp_lanczos.c:166-178)
        start = (1.0 + 1e-03 * ar).to(dt).expand(L.shape[:-2] + (n,))
    else:
        # deterministic perturbation against stagnation on a stale
        # eigenvector (ref HLanczosIPerturb, hdsdp_lanczos.c:44-53)
        pert = (ar % 7 - 3.0).to(dt) * 1e-03
        start = v0.to(dt) + pert * torch.clamp(
            torch.linalg.vector_norm(v0, dim=-1, keepdim=True).to(dt), min=1e-30
        )
    if adaptive is None:
        adaptive = return_warm
    fn = lanczos_ratio_test_adaptive if adaptive else lanczos_ratio_test
    step, warm = fn(_operator(L, dS, dt), start, krylov=krylov, nan_safe=nan_safe)
    step = step.to(L.dtype)
    if use_f32:
        step = step * 0.995
    return (step, warm) if return_warm else step


def vector_ratio_test(s: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Max alpha with s + alpha*ds > 0 elementwise for s > 0, with the
    reference's 100.0 cap when the direction is nonnegative (ref
    hdsdp_conic_lp.c:215-247, hdsdp_conic_bound.c:157-194).  s, ds [n],
    or [N, n] for a fleet (one step per instance)."""
    ratio = torch.min(ds / s) if s.ndim == 1 else torch.amin(ds / s, dim=-1)
    return torch.where(ratio >= 0.0, 100.0, -1.0 / ratio)
