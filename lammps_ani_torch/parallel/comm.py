"""The mesh communicator of a (px, py, pz) mesh of shards, in two
backends with one interface.

Stands for what the JAX package's `jax.sharding.Mesh` and, under
`shard_map`, `lax.ppermute`, `lax.axis_index`, `lax.psum` and `lax.pmax`
do (lammps_ani_tpu/parallel/domain.py:87-102). The shards are numbered in
row-major mesh order (the JAX package's `_flat_shard_index`: (ix * py +
iy) * pz + iz). A process holds `n_local` of them, and its per-shard
tensors are batched [n_local, ...] in that order:

  * `LocalMesh`: every shard in this process, on one device (n_local =
    n_shards). A ppermute is `torch.roll` of the [px, py, pz, ...] view, a
    reduction one over the shard dimension.
  * `ProcessGroupMesh`: one shard a rank of a `torch.distributed` process
    group (n_local = 1), the shard's index the rank's. A ppermute is one
    `batch_isend_irecv` with the two axis neighbors, a reduction an
    `all_reduce`.

The interface:

  * `shift(x, axis, direction)`: the ppermute along one mesh axis that
    sends each shard's block to its neighbor `direction` (+1: right), so
    each shard receives its left neighbor's; the identity on an axis of
    size 1 (where the exchange is a periodic self-image, as in the JAX
    package's `_ppshift`). Its backward is the inverse shift: the
    cotangent of a received block goes back to the shard that sent it.
  * `axis_index(axis)`, `coords()`: the local shards' mesh coordinates.
  * `local_shards`: their flat indices; `rank`: the process's rank (0 for
    `LocalMesh`), the one that writes files.
  * `psum`, `pmax`: [n_local, ...] -> the reduction over every shard
    (bools as integers under the process group).
  * `all_gather`: [n_local, ...] -> [n_shards, ...] in flat shard order.
  * `rank_generator(g)`: the generator this process draws its shards'
    noise from: `g` itself on `LocalMesh` (one stream over every shard);
    under the process group a generator of the rank's own, seeded from
    `g`'s seed and the rank (the JAX engine folds its key per shard).

Under the process group `psum`, `pmax` and `all_gather` run outside
autograd, and every rank must make the same calls in the same order: a
rank that takes another branch hangs the group at its next exchange.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _check_shape(mesh_shape) -> tuple[int, int, int]:
    shape = tuple(int(p) for p in mesh_shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh_shape {mesh_shape}: expected three "
                         "positive sizes")
    return shape


def _coords(mesh_shape, flat: torch.Tensor) -> torch.Tensor:
    """[m, 3] int64 mesh coordinates of flat shard indices."""
    _, py, pz = mesh_shape
    return torch.stack([flat // (py * pz), (flat // pz) % py, flat % pz],
                       dim=1)


class LocalMesh:
    """A (px, py, pz) mesh whose shards all live in this process, on one
    device."""

    backend = "local"
    rank = 0

    def __init__(self, mesh_shape, device=None):
        self.mesh_shape = _check_shape(mesh_shape)
        self.device = torch.device("cpu" if device is None else device)
        self._coords = _coords(self.mesh_shape,
                               torch.arange(self.n_shards,
                                            device=self.device))

    @property
    def n_shards(self) -> int:
        px, py, pz = self.mesh_shape
        return px * py * pz

    @property
    def n_local(self) -> int:
        return self.n_shards

    @property
    def local_shards(self) -> tuple[int, ...]:
        return tuple(range(self.n_shards))

    def axis_index(self, axis: int) -> torch.Tensor:
        """[n_local] int64: each local shard's coordinate along `axis`."""
        return self._coords[:, axis]

    def coords(self) -> torch.Tensor:
        """[n_local, 3] int64 mesh coordinates."""
        return self._coords

    def shift(self, x: torch.Tensor, axis: int, direction: int):
        """[n_shards, ...] -> [n_shards, ...]: shard j receives the block
        of shard j - direction along `axis` (periodic)."""
        p = self.mesh_shape[axis]
        if p == 1:
            return x
        view = x.reshape(self.mesh_shape + tuple(x.shape[1:]))
        return torch.roll(view, shifts=direction, dims=axis).reshape(x.shape)

    @staticmethod
    def psum(x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    @staticmethod
    def pmax(x: torch.Tensor) -> torch.Tensor:
        return x.max(dim=0).values

    @staticmethod
    def all_gather(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def rank_generator(g):
        return g


class _Shift(torch.autograd.Function):
    """The process group's shift; its backward sends the cotangent back
    (the same exchange, the direction negated)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, direction):
        ctx.mesh, ctx.axis, ctx.direction = mesh, axis, direction
        return mesh._exchange(x, axis, direction)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._exchange(g, ctx.axis, -ctx.direction), None, None,
                None)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor both backends send (bools as uint8)."""
    x = x.detach().contiguous()
    return x.to(torch.uint8) if x.dtype == torch.bool else x


class ProcessGroupMesh:
    """A (px, py, pz) mesh of one shard a rank of a `torch.distributed`
    process group (the default group where `group` is None), the shard's
    flat index the rank's. The group's size must be px * py * pz; its
    first call, an all-reduce every rank joins, is made here (NCCL needs
    the current device set by then)."""

    def __init__(self, mesh_shape, group=None, device=None):
        self.mesh_shape = _check_shape(mesh_shape)
        self.group = group
        world = dist.get_world_size(group)
        if world != self.n_shards:
            raise ValueError(
                f"mesh_shape {self.mesh_shape} has {self.n_shards} shards "
                f"but the process group has {world} ranks (one shard a "
                "rank)")
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device("cpu" if device is None else device)
        self._coords = _coords(self.mesh_shape,
                               torch.tensor([self.rank], device=self.device))
        self._coord = tuple(int(c) for c in self._coords[0].cpu())
        # collective calls made, by kind (a shift on an axis of size 1
        # makes none)
        self.calls = {"p2p": 0, "all_reduce": 0, "all_gather": 0}
        self._all_reduce(torch.zeros(1, device=self.device),
                         dist.ReduceOp.SUM)

    @property
    def n_shards(self) -> int:
        px, py, pz = self.mesh_shape
        return px * py * pz

    @property
    def n_local(self) -> int:
        return 1

    @property
    def local_shards(self) -> tuple[int, ...]:
        return (self.rank,)

    def axis_index(self, axis: int) -> torch.Tensor:
        return self._coords[:, axis]

    def coords(self) -> torch.Tensor:
        return self._coords

    def _peer(self, axis: int, step: int) -> int:
        """The global rank of the shard `step` away along `axis`."""
        c = list(self._coord)
        c[axis] = (c[axis] + step) % self.mesh_shape[axis]
        _, py, pz = self.mesh_shape
        flat = (c[0] * py + c[1]) * pz + c[2]
        return flat if self.group is None else dist.get_global_rank(
            self.group, flat)

    def _exchange(self, x: torch.Tensor, axis: int, direction: int):
        """Send `x` to the neighbor `direction` along `axis`, receive the
        block of the one on the other side: both ops in one batch, so the
        pair also matches on an axis of size 2, where the two neighbors
        are one rank."""
        send = _wire(x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, self._peer(axis, direction),
                          self.group),
               dist.P2POp(dist.irecv, recv, self._peer(axis, -direction),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.calls["p2p"] += 1
        return recv.bool() if x.dtype == torch.bool else recv

    def shift(self, x: torch.Tensor, axis: int, direction: int):
        """[1, ...] -> [1, ...]: the block of the shard `direction` behind
        along `axis` (periodic), differentiable."""
        if self.mesh_shape[axis] == 1:
            return x
        if x.requires_grad:
            return _Shift.apply(x, self, axis, direction)
        return self._exchange(x, axis, direction)

    def _all_reduce(self, y: torch.Tensor, op) -> torch.Tensor:
        wire = _wire(y).clone()
        dist.all_reduce(wire, op=op, group=self.group)
        self.calls["all_reduce"] += 1
        return wire.bool() if y.dtype == torch.bool else wire

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x.sum(dim=0), dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x.max(dim=0).values, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...] -> [n_shards, ...], in rank (flat shard) order."""
        send = _wire(x)
        parts = [torch.empty_like(send) for _ in range(self.n_shards)]
        dist.all_gather(parts, send, group=self.group)
        self.calls["all_gather"] += 1
        out = torch.cat(parts)
        return out.bool() if x.dtype == torch.bool else out

    def rank_generator(self, g):
        """A generator of this rank's own, on `g`'s device (the CPU where
        `g` is None, the default generator), seeded from `g`'s seed and the
        rank."""
        seed = g.initial_seed() if g is not None else torch.initial_seed()
        mixed = int(np.random.SeedSequence([seed, self.rank]).generate_state(
            1, np.uint64)[0])
        return torch.Generator(
            device=g.device if g is not None else "cpu").manual_seed(mixed)
