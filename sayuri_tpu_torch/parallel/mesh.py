"""The data-parallel "mesh" over a ``torch.distributed`` group (port of
sayuri_tpu.parallel.mesh).

In the JAX package a ``jax.sharding.Mesh`` over the devices carries the
batch-dimension sharding and XLA inserts the all-reduces. Here a ``Mesh``
holds the process group, this rank's device and the world size, and the
code that needs a collective asks the mesh for it: the trainer's gradient,
loss-part and batch-norm all-reduces, the weights' broadcast. Convnets on
19x19 boards need no tensor or pipeline axis: every parameter is
replicated, the batch is split over the ranks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from sayuri_tpu_torch.parallel import distributed as DI


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: the backward sums the incoming
    gradients over the ranks too (as ``SyncBatchNorm`` does), so that each
    rank's gradient is that of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass
class Mesh:
    """One data axis over every rank of a process group."""

    group: object
    device: torch.device
    size: int
    rank: int

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the ranks (differentiable)."""
        return _AllReduceSum.apply(x, self.group)

    def all_reduce_mean_(self, tensors):
        """Replace each tensor of the list by its mean over the ranks: one
        all-reduce over the flattened tensors. Not differentiable."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat /= self.size
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The mesh over the joined group (``distributed.initialize`` first);
    `n_devices`, when given, must be its world size. This rank's device is
    its card under NCCL, the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the group has {size} ranks")
    return Mesh(group=dist.group.WORLD, device=DI.comm_device(), size=size,
                rank=dist.get_rank())


def _rows(mesh: Mesh, x):
    b = x.shape[0]
    if b % mesh.size:
        raise ValueError(f"batch of {b} does not split over {mesh.size} ranks")
    per = b // mesh.size
    return torch.as_tensor(x[mesh.rank * per:(mesh.rank + 1) * per], device=mesh.device)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a host batch (its first dimension split evenly
    over the ranks, in rank order), as tensors on the rank's device; for an
    array, a tensor, or a dict of them."""
    if isinstance(tree, dict):
        return {k: _rows(mesh, v) for k, v in tree.items()}
    return _rows(mesh, tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's values of every tensor of `tree` on every rank (a state
    dict or a list of tensors, updated in place and returned)."""
    return DI.broadcast_from_host0(tree)


def batch_spec(mesh: Mesh) -> tuple:
    """The batch's placement: its first dimension split over the ranks
    (``PartitionSpec("data")`` in the JAX package). Nothing here reads it:
    ``shard_batch`` is the split."""
    return ("data",)


def replicated_spec(mesh: Mesh) -> tuple:
    """The parameters' placement: a copy on every rank (``PartitionSpec()``).
    Nothing here reads it: ``replicate`` makes the copies."""
    return ()
