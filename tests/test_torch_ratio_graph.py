"""The Lanczos over static buffers (``ops/ratio.py`` ``_static_basis``),
against the loop in fresh buffers (``_fresh_basis``), in its fixed-depth
and its adaptive form.

On the CPU the static loop runs eagerly: the same operations over buffers
that every test of a key reuses, which is what the CUDA graphs replay.  It has to give the fresh loop's bits
call by call whatever ran before it on the same or another key: stale rows
of V from the last test, a returned warm vector that aliases a buffer, or a key that
leaves out the batch or the depth would each show here.  The public CPU
path never touches the static buffers.  The card tests hold the graph path
itself to the eager loop, bit for bit.  No JAX here: the reference is the
port's own fresh loop.
"""

import threading

import numpy as np
import pytest
import torch

from hdsdp_tpu_torch.ops import ratio as tratio
from hdsdp_tpu_torch.utils import profile as tprofile


def _case(lead, n, seed):
    """(L, dS, v0) as the fused driver hands a group to the test: an f64
    factor of an SPD S, a symmetric direction, an f32 start vector."""
    rng = np.random.default_rng(seed)
    b = int(np.prod(lead))
    Q = rng.standard_normal((b, n, n))
    S = Q @ np.swapaxes(Q, 1, 2) / n + 1e-3 * np.eye(n)
    G = rng.standard_normal((b, n, n))
    L = np.linalg.cholesky(S).reshape(lead + (n, n))
    dS = ((G + np.swapaxes(G, 1, 2)) / np.sqrt(n)).reshape(lead + (n, n))
    v0 = rng.standard_normal(lead + (n,)).astype(np.float32)
    return torch.as_tensor(L), torch.as_tensor(dS), torch.as_tensor(v0)


# each scenario: the (lead, n, depth) of consecutive tests, each on new L and dS
SCENARIOS = {
    "consecutive": [((1,), 256, 16)] * 3,
    "depth": [((1,), 256, 16), ((1,), 256, 30), ((1,), 256, 16)],
    "fleet": [((3, 1), 200, 16)] * 3,
    "shapes": [((1,), 256, 16), ((1,), 200, 16), ((3, 1), 200, 16), ((1,), 256, 16)],
    "evicted": [((1,), 200, 16), ((1,), 256, 16), ((2, 1), 200, 16), ((1,), 200, 16)],
}


@pytest.fixture
def fresh_static(monkeypatch):
    """Empty per-thread tables of static buffers (and, on the card, new
    side streams and graph pools) for the test, the process's own left as
    they were; returns them."""
    monkeypatch.setattr(tratio, "_LOCAL", tratio._ThreadStatic())
    return tratio._LOCAL


def _run(loop, mv, v0, k, basis):
    if loop == "fixed":
        return tratio._lanczos_fixed(mv, v0, k, True, basis)
    return tratio._lanczos_adaptive(mv, v0, k, 3, True, basis)


@pytest.mark.parametrize("loop", ["fixed", "adaptive"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_static_loop_matches_fresh_loop(monkeypatch, fresh_static, scenario, loop):
    """Call by call the static loop gives the fresh loop's step and warm
    vector to the bit; each test warm-starts from the last one's warm
    vector where the shape allows, as the fused driver does; what a test
    returned is still intact after the later ones; "evicted" keeps two
    keys, so its last test rebuilds the first key's buffers.  The adaptive
    loop stops early on its own reads, leaving rows of V unbuilt."""
    if scenario == "evicted":
        monkeypatch.setattr(tratio, "STATIC_KEYS", 2)
    kept, warm = [], None
    for j, (lead, n, k) in enumerate(SCENARIOS[scenario]):
        L, dS, v0 = _case(lead, n, 100 * j + n)
        if warm is not None and warm.shape == v0.shape:
            v0 = warm
        mv = tratio._operator(L, dS, torch.float32)
        want = _run(loop, mv, v0, k, tratio._fresh_basis)
        got = _run(loop, mv, v0, k, tratio._static_basis)
        buf = fresh_static.keys[(v0.device, lead, n, torch.float32, k)]
        assert buf.V.shape == lead + (k + 1, n) and buf.T.shape == lead + (k + 1, k + 1)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (scenario, j)
            for t in (buf.V, buf.T, buf.w):
                assert g.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
        kept.append((got, tuple(t.clone() for t in got)))
        warm = got[1]
    for got, copy in kept:
        assert all(torch.equal(g, c) for g, c in zip(got, copy))
    assert len(fresh_static.keys) <= (2 if scenario == "evicted" else len(SCENARIOS[scenario]))


def test_static_buffers_are_per_thread(fresh_static):
    """Two threads run the static loop at once, step against step, on the
    same key: each thread gets buffers of its own and the fresh loop's
    bits for each of its tests, and the calling thread's table stays
    empty."""
    cases = [_case((1,), 256, 50 + j) for j in range(4)]
    mvs = [tratio._operator(L, dS, torch.float32) for L, dS, _ in cases]
    want = [tratio._lanczos_fixed(mv, v0, 16, True, tratio._fresh_basis)
            for mv, (_, _, v0) in zip(mvs, cases)]
    gate = threading.Barrier(2)
    got, bufs, errors = {}, {}, []

    def basis(mv, v0, k):
        V, T, step = tratio._static_basis(mv, v0, k)

        def stepped(i):
            gate.wait()  # the two threads take their steps in lockstep
            step(i)

        return V, T, stepped

    def work(t):
        try:
            order = range(4) if t == 0 else reversed(range(4))
            got[t] = {j: tratio._lanczos_fixed(mvs[j], cases[j][2], 16, True, basis) for j in order}
            bufs[t] = list(tratio._LOCAL.keys.values())
        except BaseException as e:  # noqa: BLE001 - handed to the test's thread
            gate.abort()
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert len(bufs[0]) == len(bufs[1]) == 1 and bufs[0][0] is not bufs[1][0]
    assert len(fresh_static.keys) == 0
    for t in range(2):
        for j in range(4):
            assert all(torch.equal(g, w) for g, w in zip(got[t][j], want[j])), (t, j)


@pytest.mark.parametrize("caller", ["fused", "psdp", "host_loop"])
def test_cpu_never_captures(fresh_static, caller):
    """On the CPU ``block_ratio`` keeps today's loop for each of its three
    callers' forms (the fused driver's warm fixed depth, PSDP's cold depth
    30, the host loop's adaptive test): no static buffer is made, both
    graph counters stay 0, and the fixed-depth bits are the fresh loop's."""
    L, dS, v0 = _case((1,), 256, 7)
    kw = {"fused": dict(krylov=16, v0=v0, return_warm=True, adaptive=False, nan_safe=True),
          "psdp": dict(mode="auto"),
          "host_loop": dict(krylov=30, v0=v0, return_warm=True)}[caller]
    with tprofile.recording() as rec:
        got = tratio.block_ratio(L, dS, **kw)
    assert rec.counters.get("ratio_inverse") == 1
    assert rec.counters.get("ratio_graph_captures", 0) == 0
    assert rec.counters.get("ratio_graph_replays", 0) == 0
    assert len(fresh_static.keys) == 0
    if caller != "host_loop":
        again = tratio.block_ratio(L, dS, **kw)
        assert all(torch.equal(a, b) for a, b in zip(
            got if isinstance(got, tuple) else (got,), again if isinstance(again, tuple) else (again,)))


def _card_case(lead, n, seed):
    """(L, dS) made on the card: an f64 factor of an SPD S with condition
    ~1e4 and a symmetric direction."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Q = torch.randn(lead + (n, n), generator=g, device="cuda", dtype=torch.float64)
    L = torch.linalg.cholesky(Q @ Q.mT / n + 1e-4 * torch.eye(n, device="cuda", dtype=torch.float64))
    G = torch.randn(lead + (n, n), generator=g, device="cuda", dtype=torch.float64)
    return L, (G + G.mT) / n ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,krylov,adaptive", [
    ((1,), 300, 16, False), ((1,), 300, 30, False), ((1,), 1000, 16, False),
    ((1,), 5000, 16, False), ((8, 1), 1000, 16, False), ((1,), 300, 30, True)])
def test_graph_path_matches_eager_on_card(monkeypatch, fresh_static, lead, n, krylov, adaptive):
    """On the card, five consecutive tests warm-started from the last
    test's warm vector, as ``cone_ratio`` runs them (fixed depth,
    ``nan_safe``) or as PSDP's dual step runs them (adaptive): the step
    graphs give the eager fresh loop's step and warm vector to the bit;
    the key's first test captures one graph a step and the later ones
    none, and every test replays one graph for each step it takes; after
    the capture no more stays allocated than the key's buffers (and the
    test's outputs): what the capture keeps reserved is held by
    ``test_graphs_share_one_pool_on_card``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [_card_case(lead, n, s) for s in range(5)]
    kw = dict(krylov=krylov, return_warm=True, adaptive=adaptive, nan_safe=not adaptive)
    graph, warm = [], None
    for j, (L, dS) in enumerate(cases):
        before = torch.cuda.memory_allocated()
        with tprofile.recording() as rec:
            out = tratio.block_ratio(L, dS, v0=warm, **kw)
        torch.cuda.synchronize()
        if j == 0:  # the key's buffers stay allocated
            (buf,) = fresh_static.keys.values()
            held = sum(t.numel() * t.element_size() for t in (buf.V, buf.T, buf.w))
            assert torch.cuda.memory_allocated() - before <= held + 2 ** 20
        assert rec.counters.get("ratio_graph_captures", 0) == (krylov if j == 0 else 0)
        steps = rec.counters.get("ratio_graph_replays", 0)
        assert steps == krylov or (adaptive and 0 < steps < krylov and steps % 3 == 0)
        graph.append(out)
        warm = out[1]
    monkeypatch.setattr(tratio, "_basis", lambda v0: tratio._fresh_basis)
    warm = None
    for j, (L, dS) in enumerate(cases):
        with tprofile.recording() as rec:
            out = tratio.block_ratio(L, dS, v0=warm, **kw)
        assert rec.counters.get("ratio_graph_replays", 0) == 0
        assert torch.equal(out[0], graph[j][0]) and torch.equal(out[1], graph[j][1]), j
        warm = out[1]
    torch.cuda.synchronize()


MiB = 2 ** 20


@pytest.mark.cuda
def test_graphs_share_one_pool_on_card(monkeypatch, fresh_static):
    """A thread's graphs share one pool, so what the captures keep
    reserved beyond the eager loop's memory is paid by the thread's first
    key: the side stream's cuBLAS workspace (32 MiB on an H100) and the
    graphs' temporaries, at most 40 MiB with the key's buffers; each later
    key reserves at most one more 2 MiB segment of the allocator's, for
    its own buffers (well under 1 MiB at every shape here).  Each key's
    eager test runs first, so the memory it caches is not counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = [((1,), 300, 16), ((1,), 300, 30), ((1,), 1000, 16), ((8, 1), 1000, 16),
              ((1,), 5000, 16)]
    kw = dict(return_warm=True, adaptive=False, nan_safe=True)
    grew = []
    for lead, n, k in shapes:
        L, dS = _card_case(lead, n, 9)
        with monkeypatch.context() as m:
            m.setattr(tratio, "_basis", lambda v0: tratio._fresh_basis)
            tratio.block_ratio(L, dS, krylov=k, **kw)
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        with tprofile.recording() as rec:
            tratio.block_ratio(L, dS, krylov=k, **kw)
        torch.cuda.synchronize()
        assert rec.counters.get("ratio_graph_captures", 0) == k
        grew.append(torch.cuda.memory_reserved() - before)
    print("reserved by each key's first test, bytes:", grew)
    assert grew[0] <= 40 * MiB, grew
    assert all(g <= 2 * MiB for g in grew[1:]), grew


@pytest.mark.cuda
def test_threads_capture_their_own_graphs_on_card(monkeypatch, fresh_static):
    """Two threads run three consecutive tests of one key each, at once:
    each captures graphs of its own into its own pool, the one while the
    other launches work, and each gets the eager loop's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [_card_case((1,), 1000, 20 + j) for j in range(3)]
    kw = dict(krylov=16, return_warm=True, adaptive=False, nan_safe=True)
    want, warm = [], None
    with monkeypatch.context() as m:
        m.setattr(tratio, "_basis", lambda v0: tratio._fresh_basis)
        for L, dS in cases:
            want.append(tratio.block_ratio(L, dS, v0=warm, **kw))
            warm = want[-1][1]
    torch.cuda.synchronize()
    gate = threading.Barrier(2)
    got, bufs, errors = {}, {}, []

    def work(t):
        try:
            gate.wait()
            out, warm = [], None
            for L, dS in cases:
                out.append(tratio.block_ratio(L, dS, v0=warm, **kw))
                warm = out[-1][1]
            torch.cuda.synchronize()
            got[t] = out
            bufs[t] = list(tratio._LOCAL.keys.values())
        except BaseException as e:  # noqa: BLE001 - handed to the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert len(bufs[0]) == len(bufs[1]) == 1 and bufs[0][0] is not bufs[1][0]
    assert bufs[0][0].graphs is not None and bufs[1][0].graphs is not None
    assert len(fresh_static.keys) == 0
    for t in range(2):
        for j in range(3):
            assert all(torch.equal(g, w) for g, w in zip(got[t][j], want[j])), (t, j)
