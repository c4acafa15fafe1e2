"""The mesh communicator: every shard of a (px, py, pz) mesh in one
process.

Stands for what the JAX package's `jax.sharding.Mesh` and, under
`shard_map`, `lax.ppermute`, `lax.axis_index`, `lax.psum` and `lax.pmax`
do (lammps_ani_tpu/parallel/domain.py:87-102). Per-shard tensors are
batched: [n_shards, ...], the shards in row-major mesh order (the JAX
package's `_flat_shard_index`: (ix * py + iy) * pz + iz).

  * `shift(x, axis, direction)`: the ppermute along one mesh axis that
    sends each shard's block to its neighbor `direction` (+1: right), so
    each shard receives its left neighbor's. It is `torch.roll` of the
    [px, py, pz, ...] view along that axis, the identity on an axis of
    size 1 (where the exchange is a periodic self-image, as in the JAX
    package's `_ppshift`). Its backward is the inverse shift: the
    cotangent of a received block goes back to the shard that sent it.
  * `axis_index(axis)`: each shard's coordinate along an axis, [n_shards].
  * `psum`, `pmax`: reductions over the shard dimension.

A process-group backend (one shard a rank) is to sit behind the same
interface; this module has only the in-process mesh.
"""

from __future__ import annotations

import torch


class LocalMesh:
    """A (px, py, pz) mesh whose shards all live in this process, on one
    device."""

    def __init__(self, mesh_shape, device=None):
        self.mesh_shape = tuple(int(p) for p in mesh_shape)
        if len(self.mesh_shape) != 3 or min(self.mesh_shape) < 1:
            raise ValueError(f"mesh_shape {mesh_shape}: expected three "
                             "positive sizes")
        self.device = torch.device("cpu" if device is None else device)
        px, py, pz = self.mesh_shape
        flat = torch.arange(px * py * pz, device=self.device)
        self._coords = torch.stack([flat // (py * pz), (flat // pz) % py,
                                    flat % pz], dim=1)

    @property
    def n_shards(self) -> int:
        px, py, pz = self.mesh_shape
        return px * py * pz

    def axis_index(self, axis: int) -> torch.Tensor:
        """[n_shards] int64: each shard's coordinate along `axis`."""
        return self._coords[:, axis]

    def coords(self) -> torch.Tensor:
        """[n_shards, 3] int64 mesh coordinates."""
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
