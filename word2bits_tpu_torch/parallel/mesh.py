"""The (data, vocab) mesh on torch.distributed, and the collectives the
shard bodies call.

The counterpart of the JAX package's parallel/mesh.py.  There one
controller drives every device of a `jax.sharding.Mesh`; here each shard
is a process on one device (multi-controller, as torchrun starts them),
and rank r sits at (di, vi) = (r // nv, r % nv):
  * "data"  — batch parallelism: data shard di takes centers
    [di * B/nd, (di+1) * B/nd) of each step;
  * "vocab" — the tables' rows: vocab shard vi owns a block of B/nv rows
    (the scaling axis for the 3.7M-word x 800d configuration).

The shard bodies (parallel/sharded*.py, parallel/chunk.py) reach the
other shards only through a `Collectives` object, the port's form of the
JAX axis primitives: `axis_index` / `axis_size` (lax.axis_index,
lax.axis_size), `psum` (lax.psum: the sum over an axis) and `all_gather`
(lax.all_gather(tiled=True): the shards' blocks concatenated in rank
order).  Two implementations:

  DistCollectives  the product path: all_reduce / all_gather on one
                   process subgroup per axis (NCCL on the card, gloo on
                   the CPU), built by `make_mesh`;
  LocalMesh        every shard of an nd x nv mesh in this process on one
                   device, one thread per shard.  The shards take turns:
                   one runs at a time, from one collective to the next, so
                   their launches keep the device's current stream in
                   order (the tiled scatter kernels share one workspace per
                   device, kernels/span_scatter.workspace) and the kernels'
                   launch counters stay exact.  `psum` adds the shards'
                   tensors in rank order, so every shard gets the same
                   bits.  It stands in for the JAX suite's 8 virtual CPU
                   devices in the tests, and holds meshes larger than one
                   card in chip_smoke.py; the trainer never uses it.
"""

from __future__ import annotations

import functools
import threading
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
VOCAB_AXIS = "vocab"
AXES = (DATA_AXIS, VOCAB_AXIS)


def mesh_dims(mesh_shape: Optional[Dict[str, int]]) -> tuple:
    """(nd, nv) of a {"data": nd, "vocab": nv} shape (absent axes are 1)."""
    mesh_shape = mesh_shape or {}
    unknown = set(mesh_shape) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)} "
                         f"(supported: {', '.join(AXES)})")
    return int(mesh_shape.get(DATA_AXIS, 1)), int(mesh_shape.get(VOCAB_AXIS, 1))


class Collectives:
    """One shard's view of the mesh: its coordinates and the collectives
    over each axis."""

    nd: int
    nv: int
    di: int
    vi: int
    device: torch.device

    @property
    def rank(self) -> int:
        return self.di * self.nv + self.vi

    def axis_index(self, axis: str) -> int:
        return {DATA_AXIS: self.di, VOCAB_AXIS: self.vi}[axis]

    def axis_size(self, axis: str) -> int:
        return {DATA_AXIS: self.nd, VOCAB_AXIS: self.nv}[axis]

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of x over the shards of `axis`; x's storage may be
        reused for the result, so pass a temporary."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The shards' x ([N, ...] each) concatenated along dim 0 in rank
        order along `axis`: [n * N, ...]."""
        raise NotImplementedError


@dataclass
class Mesh:
    """This process's place in an nd x nv mesh of processes, with one
    process subgroup per axis (the group of the shards that share its
    other coordinate)."""

    nd: int
    nv: int
    di: int
    vi: int
    device: torch.device
    groups: Dict[str, object]


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None,
              device=None) -> Mesh:
    """This rank's (data, vocab) mesh over the initialized process group
    (default: every process on the data axis).  Every rank must call it,
    in the same order as any other group it creates.  Raises ValueError
    when the mesh does not match the number of processes (a process is a
    device here): one process without a group counts as a world of 1."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_shape is None:
        mesh_shape = {DATA_AXIS: world, VOCAB_AXIS: 1}
    nd, nv = mesh_dims(mesh_shape)
    if nd * nv != world:
        raise ValueError(f"mesh {mesh_shape} needs {nd * nv} devices, "
                         f"have {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start one "
                           "with parallel.multihost.initialize (torchrun) "
                           "or start_local_group")
    di, vi = divmod(dist.get_rank(), nv)
    groups = {}
    # every rank creates every group, in this order
    for v in range(nv):
        g = dist.new_group([d * nv + v for d in range(nd)])
        if v == vi:
            groups[DATA_AXIS] = g
    for d in range(nd):
        g = dist.new_group([d * nv + v for v in range(nv)])
        if d == di:
            groups[VOCAB_AXIS] = g
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(nd=nd, nv=nv, di=di, vi=vi, device=torch.device(device),
                groups=groups)


# all_gather_into_tensor was renamed all_gather_single in later releases
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


class DistCollectives(Collectives):
    """The collectives of a `make_mesh` rank: all_reduce (sum) and
    all_gather on the axis's process subgroup."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.nd, self.nv, self.di, self.vi = mesh.nd, mesh.nv, mesh.di, mesh.vi
        self.device = mesh.device

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.mesh.groups[axis])
        return x

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        x = x.contiguous()
        out = x.new_empty((self.axis_size(axis) * x.shape[0],)
                          + tuple(x.shape[1:]))
        _all_gather_single(out, x, group=self.mesh.groups[axis])
        return out


class _Aborted(Exception):
    """Another shard of a LocalMesh run failed."""


class _Turns:
    """The round-robin schedule of a LocalMesh run: shard r runs only while
    turn == r, and hands the turn on at each collective and at its end."""

    def __init__(self, n: int, timeout: float):
        self.n, self.timeout = n, timeout
        self.turn = 0
        self.cond = threading.Condition()
        self.error: Optional[BaseException] = None
        self.calls = [0] * n             # collectives entered, per shard
        self.done = [False] * n
        self.slots: List[tuple] = [()] * n
        self.out: List[Optional[torch.Tensor]] = [None] * n

    def wait(self, r: int) -> None:
        with self.cond:
            if not self.cond.wait_for(
                    lambda: self.turn == r or self.error is not None,
                    timeout=self.timeout):
                self.fail(TimeoutError(f"LocalMesh shard {r} waited more "
                                       f"than {self.timeout} s"))
            if self.error is not None:
                raise _Aborted() from self.error

    def hand_on(self, r: int) -> None:
        with self.cond:
            self.turn = (r + 1) % self.n
            self.cond.notify_all()

    def fail(self, e: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = e
            self.cond.notify_all()


class _LocalShard(Collectives):
    """One shard of a LocalMesh run."""

    def __init__(self, mesh: "LocalMesh", rank: int, turns: _Turns):
        self.nd, self.nv = mesh.nd, mesh.nv
        self.di, self.vi = divmod(rank, mesh.nv)
        self.device = mesh.device
        self._turns = turns

    def _group(self, rank: int, axis: str) -> List[int]:
        di, vi = divmod(rank, self.nv)
        if axis == DATA_AXIS:
            return [d * self.nv + vi for d in range(self.nd)]
        return [di * self.nv + v for v in range(self.nv)]

    def _exchange(self, op: str, axis: str, x: torch.Tensor,
                  combine: Callable) -> torch.Tensor:
        t, r = self._turns, self.rank
        if any(t.done):
            raise RuntimeError("LocalMesh shards called different "
                               "collectives (a shard has finished)")
        t.calls[r] += 1
        t.slots[r] = (op, axis, x)
        if r == t.n - 1:                 # the last to arrive combines
            if len(set(t.calls)) != 1 or len({s[:2] for s in t.slots}) != 1:
                raise RuntimeError(f"LocalMesh shards called different "
                                   f"collectives: {[s[:2] for s in t.slots]}")
            for q in range(t.n):
                group = self._group(q, axis)
                if q == group[0]:
                    res = combine([t.slots[m][2] for m in group])
                    for i, m in enumerate(group):
                        t.out[m] = res if i == 0 else res.clone()
        t.hand_on(r)
        t.wait(r)
        out, t.out[r] = t.out[r], None
        return out

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.axis_size(axis) == 1:
            return x
        return self._exchange("psum", axis, x,
                              lambda xs: functools.reduce(torch.add, xs))

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._exchange("all_gather", axis, x,
                              lambda xs: torch.cat(xs, dim=0))


class LocalMesh:
    """Every shard of an nd x nv mesh in this process on `device`, one
    thread per shard, one running at a time (see the module note)."""

    def __init__(self, nd: int, nv: int, device="cpu",
                 timeout: float = 3600.0):
        if nd < 1 or nv < 1:
            raise ValueError(f"mesh data={nd} x vocab={nv}")
        self.nd, self.nv = nd, nv
        self.device = torch.device(device)
        self.timeout = timeout

    @classmethod
    def of(cls, mesh_shape: Dict[str, int], device="cpu") -> "LocalMesh":
        return cls(*mesh_dims(mesh_shape), device=device)

    def run(self, fn: Callable[[Collectives], object]) -> list:
        """[fn(shard) for every shard], shard r's call in its own thread on
        the caller's current stream; re-raises the first shard's error."""
        n = self.nd * self.nv
        turns = _Turns(n, self.timeout)
        shards = [_LocalShard(self, r, turns) for r in range(n)]
        results: list = [None] * n
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def main(r: int) -> None:
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else nullcontext()):
                    turns.wait(r)
                    results[r] = fn(shards[r])
                    with turns.cond:
                        turns.done[r] = True
                        if len(set(turns.calls)) != 1:
                            raise RuntimeError(
                                "LocalMesh shards called different "
                                f"collectives: counts {turns.calls}")
                    turns.hand_on(r)
            except _Aborted:
                pass
            except BaseException as e:   # handed to the caller below
                turns.fail(e)

        threads = [threading.Thread(target=main, args=(r,), daemon=True,
                                    name=f"local-mesh-{r}")
                   for r in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(self.timeout)
        if turns.error is None and any(th.is_alive() for th in threads):
            turns.fail(TimeoutError("LocalMesh run did not finish"))
        if turns.error is not None:
            raise turns.error
        return results
