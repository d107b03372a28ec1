"""A 1-D device mesh on ``torch.distributed`` (port of the JAX package's
parallel/mesh.py).

The JAX package's mesh path is single-controller: one process holds
arrays sharded over a ``jax.sharding.Mesh``.  The port is SPMD: one
process per rank, each running the same host loop, with the JAX
collectives mapped one to one:

    psum                      -> Mesh.all_reduce      (dist.all_reduce)
    all_gather(tiled=True)    -> Mesh.all_gather      (dist.all_gather_into_tensor)
    psum_scatter(tiled=True)  -> Mesh.reduce_scatter  (dist.reduce_scatter_tensor)
    axis_index                -> Mesh.rank

``Mesh.counts`` records how often each one ran.  Every rank must take
every host decision alike (a rank that takes another branch enters
another collective and the world hangs), so every process group is made
with a timeout, and ``assert_same`` checks that a tensor agrees bit for
bit on every rank.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import time

import torch
import torch.distributed as dist

ROW_AXIS = "row"

# the tensor forms of all_gather / reduce_scatter under their current names
_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# collective timeout of the worlds ``spawn`` makes (seconds)
DEFAULT_TIMEOUT = 120.0
# ``spawn`` kills a world that has not finished after this many seconds
WALL_TIMEOUT = 900.0


class Mesh:
    """The process group of a 1-D mesh with the axis ``"row"``: this
    process's ``rank`` of ``size``, and the device its tensors live on."""

    def __init__(self, group, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.axis = ROW_AXIS
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        self.counts: dict = {}  # collective -> calls

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, axis={self.axis!r}, "
                f"device={self.device}, backend={self.backend})")

    # -- bookkeeping ------------------------------------------------------
    def _count(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset_counts(self) -> None:
        self.counts = {}

    # -- the collectives ----------------------------------------------------
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """psum (op="sum"), pmax or pmin over the mesh; a new tensor."""
        out = t.contiguous().clone()
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        self._count("all_reduce")
        dist.all_reduce(out, op=rop, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """all_gather(tiled=True): the ranks' tensors stacked along dim 0
        in rank order."""
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        self._count("all_gather")
        _gather(out, t, group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """psum_scatter(tiled=True) along dim 0: this rank's block of rows
        of the sum over ranks."""
        t = t.contiguous()
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: {t.shape[0]} rows over {self.size} ranks")
        k = t.shape[0] // self.size
        out = torch.empty((k,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        self._count("reduce_scatter")
        _scatter(out, t, group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s tensor on every rank (the other ranks pass a
        tensor of the same shape, whose values are ignored)."""
        out = t.contiguous().clone()
        self._count("broadcast")
        dist.broadcast(out, src=dist.get_global_rank(self.group, src)
                       if self.group is not None else src, group=self.group)
        return out

    # -- agreement ------------------------------------------------------------
    def assert_same(self, t: torch.Tensor, what: str = "tensor") -> None:
        """Raise unless ``t`` is bit-equal on every rank (one all_reduce of
        max over [t, -t]: max and -min over the ranks both equal t)."""
        t = t.reshape(-1).to(torch.float64)
        both = self.all_reduce(torch.cat([t, -t]), op="max")
        hi, lo = both[:t.numel()], -both[t.numel():]
        nan = t.isnan()
        same = (torch.equal(hi.isnan(), nan) and torch.equal(lo.isnan(), nan)
                and torch.equal(hi.masked_fill(nan, 0), t.masked_fill(nan, 0))
                and torch.equal(lo.masked_fill(nan, 0), t.masked_fill(nan, 0)))
        if not same:
            raise RuntimeError(f"mesh rank {self.rank}: {what} differs between ranks")


def make_mesh(device, group=None) -> Mesh:
    """The mesh of an initialised ``torch.distributed`` process group
    (default: the world) on ``device``.  There is no single-device mesh
    without a group: call ``dist.init_process_group`` first (or run under
    ``spawn``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(dist.init_process_group, or parallel.mesh.spawn)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {device!r}: torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {device!r}")
    backend = dist.get_backend(group)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL mesh needs a CUDA device")
    return Mesh(group, dev)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(rank: int, world_size: int, backend: str, port: int,
               timeout: float = DEFAULT_TIMEOUT) -> None:
    """``dist.init_process_group`` on tcp://127.0.0.1:<port> with a
    timeout, so that ranks that diverge fail instead of hanging."""
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))


def _worker(rank, fn, world_size, backend, device, port, timeout, args, out_dir):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(torch.device(device))
    init_world(rank, world_size, backend, port, timeout)
    try:
        mesh = make_mesh(device)
        result = fn(mesh, *args)
        if rank == 0:
            path = os.path.join(out_dir, "rank0.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(result, f)
            os.replace(path + ".tmp", path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, device, *args,
          timeout: float = DEFAULT_TIMEOUT):
    """Run ``fn(mesh, *args)`` on a fresh world of ``world_size`` processes
    (``torch.multiprocessing.spawn``, tcp://127.0.0.1 on a free port, one
    torch thread per rank on the CPU, collectives timing out after
    ``timeout`` seconds) and return rank 0's result, which must pickle.
    ``fn`` must be importable by the children (a module-level function of
    an importable module).  The whole world is killed after
    ``WALL_TIMEOUT`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        port = free_port()
        ctx = mp.spawn(_worker, args=(fn, world_size, backend, str(device), port, timeout,
                                      tuple(args), out_dir),
                       nprocs=world_size, join=False)
        deadline = time.time() + WALL_TIMEOUT
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"spawned world of {world_size} did not finish in {WALL_TIMEOUT} s")
        with open(os.path.join(out_dir, "rank0.pkl"), "rb") as f:
            return pickle.load(f)
