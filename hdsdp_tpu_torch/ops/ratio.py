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

A fixed-depth test issues ~20 small vector operations a step beside its
three products, so on CUDA the host's launches, not the device, set its
pace.  There each step's vector work replays one captured CUDA graph
(``_static_basis``) over buffers that every test of the same (device,
batch, n, dtype, depth) reuses, O(k n) of them, in the fixed-depth and the
adaptive form alike; the products run eagerly on this test's L^{-1} and
-dS, whose addresses change from test to test.  A thread captures every
key on one side stream into one memory pool, which keeps reserved the
side stream's cuBLAS workspace (32 MiB on an H100) and the graphs'
temporaries, once for the thread and not per key.  Counters
``ratio_graph_captures`` (one per captured graph) and
``ratio_graph_replays`` (one per replay).  On the CPU every test
allocates fresh buffers and launches each operation.

On a non-finite matrix ``torch.linalg.eigh``/``eigvalsh`` raise where
``jnp.linalg.eigh`` returns NaN pairs; ``nan_safe=True`` gives the JAX
behaviour (the fused IPM bodies run on through a failed Schur factor, as
the JAX programs do).  On CUDA both calls wait for the device to check
their ``info``.
"""

from __future__ import annotations

import threading

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
    Linv = L^{-1} and dSneg = -dS; with ``out`` the last product writes
    into it."""
    LinvT = Linv.mT

    def mv(x, out=None):
        y = dSneg @ (LinvT @ x[..., None])
        if out is None:
            return (Linv @ y)[..., 0]
        torch.matmul(Linv, y, out=out[..., None])
        return out

    return mv


def _lanczos_step(mv, V, T, i):
    """One reorthogonalized Lanczos step of the operator ``mv``: fills
    T[.., i, i], T[.., i+1, i], T[.., i, i+1] and V[.., i+1, :] in place."""
    _lanczos_update(mv(V[..., i, :]), V, T, i)


def _lanczos_update(w, V, T, i):
    """Step i of the Lanczos after its product w = mv(V[.., i, :]), which
    it reads and does not write."""
    vi = V[..., i, :]
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


def _start_basis(v0, V, T):
    """Zero the basis V and the tridiagonal T, and put v0 normalised in
    V's first row."""
    V.zero_()
    T.zero_()
    V[..., 0, :] = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)


def lanczos_ratio_test(mv, v0, krylov: int = 30, nan_safe: bool = False):
    """Fixed-depth batched Lanczos bound on the max step of the operator
    ``mv`` (conservative, like the reference).  Returns (steps [...], warm
    start for the next call).  On CUDA ``mv(x, out=w)`` has to write its
    product into w, as ``_gemv_matvec``'s does."""
    return _lanczos_fixed(mv, v0, min(krylov, v0.shape[-1]), nan_safe, _basis(v0))


def _lanczos_fixed(mv, v0, k: int, nan_safe: bool, basis):
    V, T, step = basis(mv, v0, k)
    for i in range(k):
        step(i)
    w_eigs, Y = _eig(torch.linalg.eigh, T[..., :k, :k], nan_safe)
    return _bound_from_pairs(mv, V[..., :k, :], w_eigs, Y)


def lanczos_ratio_test_adaptive(mv, v0, krylov: int = 30, check_freq: int = 3,
                                nan_safe: bool = False):
    """Early-exit Lanczos bound (ref hdsdp_lanczos.c:186-292): the same
    recurrence, stopped as soon as every matrix in the batch has a
    converged top Ritz pair, |beta_k * y1[k]| < 1e-4, checked every
    ``check_freq`` steps and at the last step (one host read each).  Its
    steps are those of ``lanczos_ratio_test`` at the same depth, graphs
    and buffers included, so on CUDA ``mv`` has to take ``out=`` here too.

    The Ritz pairs are those of the leading block of T built so far.  The
    JAX package keeps a fixed shape for its compiler instead: it pads the
    rows not yet built with -1e12 on the diagonal, which decouples them.
    LAPACK splits such rows off, but cuSOLVER's f32 eigensolver does not
    always: on the padded matrix it returned top pairs wrong by percents
    (step bounds up to 8 % ABOVE the exact step at n = 3375, which stalled
    phase B) or gave up (n = 1000)."""
    return _lanczos_adaptive(mv, v0, min(krylov, v0.shape[-1]), check_freq, nan_safe,
                             _basis(v0))


def _lanczos_adaptive(mv, v0, k: int, check_freq: int, nan_safe: bool, basis):
    V, T, step = basis(mv, v0, k)
    i = 0
    while i < k:
        step(i)
        i += 1
        if i % check_freq == 0 or i >= k:
            w_eigs, Y = _eig(torch.linalg.eigh, T[..., :i, :i], nan_safe)
            resi = torch.abs(T[..., i, i - 1] * Y[..., i - 1, -1])
            profile.count("host_reads")
            if bool(torch.max(resi) < 1e-04):  # host sync
                break
    return _bound_from_pairs(mv, V[..., :i, :], w_eigs, Y)


def _basis(v0):
    """How a Lanczos from v0 gets its buffers and runs its steps: the
    static buffers and step graphs on CUDA, fresh buffers elsewhere."""
    return _static_basis if v0.is_cuda else _fresh_basis


def _fresh_basis(mv, v0, k: int):
    """(V, T, step) for a Lanczos of ``mv`` from v0 at depth k in new
    buffers: the basis, the tridiagonal, and step(i), which runs step i
    operation by operation."""
    V = v0.new_empty(v0.shape[:-1] + (k + 1, v0.shape[-1]))
    T = v0.new_empty(v0.shape[:-1] + (k + 1, k + 1))
    _start_basis(v0, V, T)
    return V, T, lambda i: _lanczos_step(mv, V, T, i)


def _static_basis(mv, v0, k: int):
    """``_fresh_basis`` over the static buffers of v0's key: step i writes
    its product into w by ``mv(x, out=w)``, then on CUDA replays the
    step's graph, captured at the key's first test, and elsewhere (the
    tests alone) launches the same operations.  Either way the operations,
    their order and their shapes are the fresh loop's, and so are the
    bits."""
    buf = _static(v0, k)
    if v0.is_cuda and buf.graphs is None:
        buf.capture(*_capturer(v0.device))
    V, T, w = buf.V, buf.T, buf.w
    _start_basis(v0, V, T)

    def step(i):
        mv(V[..., i, :], out=w)
        if buf.graphs is None:
            _lanczos_update(w, V, T, i)
        else:
            buf.graphs[i].replay()
            profile.count("ratio_graph_replays")

    return V, T, step


# keys (device, batch, n, dtype, depth) whose buffers and graphs a thread
# keeps, so that a key is captured once and not once a solve; the oldest
# goes first.  A benchmark cell uses one or two (PERF.md section 6).
STATIC_KEYS = 8


class _ThreadStatic(threading.local):
    """What one thread keeps between its Lanczos tests: the static buffers
    of each key, and per device the side stream that captures the graphs
    and the one memory pool that all its graphs share.  Each thread has
    its own, so tests in two threads share nothing."""

    def __init__(self):
        self.keys = {}
        self.capturers = {}


_LOCAL = _ThreadStatic()


def _capturer(device):
    """(side stream, graph pool) of this thread on ``device``."""
    got = _LOCAL.capturers.get(device)
    if got is None:
        got = _LOCAL.capturers[device] = (torch.cuda.Stream(device),
                                          torch.cuda.graph_pool_handle())
    return got


class _StaticLanczos:
    """The buffers that every Lanczos test of one key reuses: the basis
    V [..., k+1, n], the tridiagonal T [..., k+1, k+1] and the step's
    product w [..., n], O(k n) in all; on CUDA, once captured, one graph
    per step index i that replays ``_lanczos_update(w, V, T, i)`` over
    them.  Nothing a test returns lies in them: the next test overwrites
    them."""

    def __init__(self, batch, n: int, k: int, dtype, device):
        self.V = torch.zeros(batch + (k + 1, n), dtype=dtype, device=device)
        self.T = torch.zeros(batch + (k + 1, k + 1), dtype=dtype, device=device)
        self.w = torch.zeros(batch + (n,), dtype=dtype, device=device)
        self.graphs = None

    def capture(self, side, pool):
        """Capture the k step graphs on the thread's side stream into its
        pool, after one eager pass on the current stream that sets up what
        the operations set up lazily.  Both run over whatever the buffers
        hold: every test resets them first.  The capture's error mode is
        the thread's own, so that other threads may launch work meanwhile.

        No graph's temporary outlives its capture, so graphs that share the
        pool may replay in any order, as long as one at a time.  cuBLAS
        keeps a workspace (32 MiB on an H100) for each stream it runs on;
        the side stream's is made inside the pool by the capture's
        first product, and dropped after the capture (cuBLAS's workspaces are
        dropped all at once; the current stream's is made again at its
        next product): the pool keeps its memory reserved for the replays,
        and the next key's capture makes the workspace again in that memory.
        So the workspace is reserved once for the thread and not allocated
        while the solver runs.  Dropping them all holds while no other
        graph of the process that ran cuBLAS is still to be replayed: the
        program captures no other."""
        k = self.T.shape[-1] - 1
        with torch.cuda.device(self.V.device):
            for i in range(k):
                _lanczos_update(self.w, self.V, self.T, i)
            side.wait_stream(torch.cuda.current_stream())
            graphs = []
            with torch.cuda.stream(side):
                try:
                    for i in range(k):
                        g = torch.cuda.CUDAGraph()
                        g.capture_begin(pool=pool, capture_error_mode="thread_local")
                        try:
                            _lanczos_update(self.w, self.V, self.T, i)
                        finally:
                            g.capture_end()
                        graphs.append(g)
                        profile.count("ratio_graph_captures")
                finally:
                    torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.current_stream().wait_stream(side)
        self.graphs = graphs


def _static(v0, k: int) -> _StaticLanczos:
    """This thread's static buffers of v0's key at depth k, made on first
    use."""
    keys = _LOCAL.keys
    key = (v0.device, tuple(v0.shape[:-1]), v0.shape[-1], v0.dtype, k)
    buf = keys.get(key)
    if buf is not None:
        return buf
    if len(keys) >= STATIC_KEYS:
        old = keys.pop(next(iter(keys)))
        if old.graphs is not None:  # none of its replays may still be in flight
            torch.cuda.synchronize(old.V.device)
    buf = keys[key] = _StaticLanczos(v0.shape[:-1], v0.shape[-1], k, v0.dtype, v0.device)
    return buf


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
