"""The ``model`` axis: FSDP-style sharding of the train state over ranks.

Counterpart of ``bio_diffusion_tpu/parallel/mesh.py``'s ``make_mesh``,
``param_sharding_rules`` and ``shard_pytree``.  A world of ``W`` ranks with
``trainer.num_model_shards = M`` forms a mesh of ``D = W / M`` data groups
by ``M`` model shards; rank ``r`` sits at ``(r // M, r % M)``, as JAX's
``np.asarray(devices).reshape(data, model)`` places its devices.  The ``M``
ranks of one row (a *model group*) share one copy of the train state: of
every parameter, EMA and AMSGrad leaf each keeps its ``1/M`` slice along
the dimension JAX's rule picks (``shard_dim``, on the port's own shapes),
or the whole leaf where no dimension divides ``M``.  The ``D`` ranks of
one column (a *data group*) hold the same slices.

XLA inserts the JAX package's collectives; here they are written out over
flat buffers, one call a dtype (``ModelShards``): a step gathers the full
parameters inside its model group (``all_gather_into_tensor``), computes
on its rows of the global batch as data parallelism does, reduce-scatters
the gradients inside the model group (``reduce_scatter_tensor``, SUM) and
all-reduces the shards across the data group; the replicated leaves'
gradients are all-reduced over the world with the step's metrics.  NCCL
and gloo (on the CPU, and over CUDA tensors where two ranks share a card)
run the same two collectives.  A one-process run has no mesh (JAX's
``default_mesh`` is None on one device) and trains unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# the collectives a model group runs, on every backend (gloo has both for
# CPU and CUDA tensors, NCCL for CUDA tensors)
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor")


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """``data`` groups by ``model`` shards."""

    data: int
    model: int

    def coords(self, rank: int) -> Tuple[int, int]:
        """Rank ``rank``'s ``(data index, model index)``."""
        return divmod(int(rank), self.model)

    def model_ranks(self, d: int) -> List[int]:
        """The ranks of model group ``d`` (one copy of the state)."""
        return list(range(d * self.model, (d + 1) * self.model))

    def data_ranks(self, m: int) -> List[int]:
        """The ranks of data group ``m`` (those holding slice ``m``)."""
        return list(range(m, self.data * self.model, self.model))


def mesh_layout(world: int, num_model_shards: int) -> MeshLayout:
    """``world`` ranks as ``data x model``.  One rank has no model axis
    (``model`` 1, as JAX's ``default_mesh`` returns no mesh on one device);
    a world that ``num_model_shards`` does not divide raises ``ValueError``
    (JAX's ``make_mesh`` assert)."""
    world, m = int(world), int(num_model_shards)
    if m < 1:
        raise ValueError(f"trainer.num_model_shards={m}: must be at least 1")
    if world <= 1:
        return MeshLayout(1, 1)
    if world % m:
        raise ValueError(f"a world of {world} ranks does not divide into trainer.num_model_shards={m} model shards")
    return MeshLayout(world // m, m)


def new_mesh_groups(layout: MeshLayout, rank: int) -> Tuple[Any, Any]:
    """This rank's (model group, data group).  ``dist.new_group`` is a
    collective of the whole world, so every rank creates every group, in
    the same order: the model groups by data index, then the data groups
    by model index."""
    d, m = layout.coords(rank)
    model_groups = [dist.new_group(layout.model_ranks(i)) for i in range(layout.data)]
    data_groups = [dist.new_group(layout.data_ranks(j)) for j in range(layout.model)]
    return model_groups[d], data_groups[m]


def shard_dim(shape: Sequence[int], model: int) -> Optional[int]:
    """JAX's ``param_sharding_rules`` for one leaf: the largest dimension
    that ``model`` divides (the first of equal ones), or None (replicated)
    for ``model`` 1, a 0-dim leaf or no such dimension."""
    shape = [int(s) for s in shape]
    if model == 1 or not shape:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % model == 0 and shape[i] >= model:
            return i
    return None


def param_sharding_rules(tensors: Sequence[Tensor], model: int) -> List[Optional[int]]:
    """``shard_dim`` of each tensor."""
    return [shard_dim(t.shape, model) for t in tensors]


class ModelShards:
    """The sharding of a list of leaves (the parameters; their EMA and
    moments share it) over this rank's model group of ``dp`` (a
    ``parallel.distributed.DataParallel`` with ``model > 1``)."""

    def __init__(self, leaves: Sequence[Tensor], dp):
        self.dp = dp
        self.model, self.index = dp.model, dp.rank % dp.model
        self.shapes = [tuple(t.shape) for t in leaves]
        self.dims = param_sharding_rules(leaves, self.model)
        self.sharded = [i for i, d in enumerate(self.dims) if d is not None]
        self.replicated = [i for i, d in enumerate(self.dims) if d is None]

    def describe(self) -> str:
        """The collectives and the group, for logs."""
        return f"{self.dp.backend}: {' + '.join(COLLECTIVES)} over {self.model} model shards"

    def _split(self, i: int) -> Tuple[int, ...]:
        """Leaf ``i``'s shape with its shard dimension split into ``(M, k)``."""
        d, s = self.dims[i], self.shapes[i]
        return s[:d] + (self.model, s[d] // self.model) + s[d + 1:]

    def _by_dtype(self, tensors: Sequence[Tensor]) -> List[List[int]]:
        groups: dict = {}
        for i in self.sharded:
            groups.setdefault(tensors[i].dtype, []).append(i)
        return list(groups.values())

    def slice(self, tensors: Sequence[Tensor]) -> List[Tensor]:
        """This rank's slices of ``tensors``: a contiguous copy of its
        ``1/M`` of each sharded leaf, the leaf itself where replicated."""
        out = list(tensors)
        with torch.no_grad():
            for i in self.sharded:
                k = self.shapes[i][self.dims[i]] // self.model
                out[i] = tensors[i].detach().narrow(self.dims[i], self.index * k, k).clone(
                    memory_format=torch.contiguous_format)
        return out

    def release_(self, fulls: Sequence[Tensor]) -> None:
        """Free the storage of the sharded leaves of ``fulls`` (their shapes
        stay; ``gather_`` fills them again)."""
        for i in self.sharded:
            fulls[i].untyped_storage().resize_(0)

    @torch.no_grad()
    def gather_(self, shards: Sequence[Tensor], fulls: Sequence[Tensor]) -> None:
        """Write the model group's slices of each sharded leaf into
        ``fulls[i]`` (contiguous tensors of the full shapes, e.g. released
        parameters), through ``copy_`` on the tensor itself, which bumps
        its version counter as every in-place update does.  Replicated
        leaves are not touched (their shard is the leaf)."""
        for i in self.sharded:
            storage, need = fulls[i].untyped_storage(), fulls[i].numel() * fulls[i].element_size()
            if storage.nbytes() < need:
                storage.resize_(need)
        for idx in self._by_dtype(shards):
            local = torch.cat([shards[i].reshape(-1) for i in idx])
            out = local.new_empty(self.model * local.numel())
            dist.all_gather_into_tensor(out, local, group=self.dp.model_group)
            out = out.view(self.model, -1)
            offset = 0
            for i in idx:
                n, d = shards[i].numel(), self.dims[i]
                piece = out[:, offset: offset + n].reshape((self.model,) + tuple(shards[i].shape))
                fulls[i].view(self._split(i)).copy_(piece.movedim(0, d))
                offset += n

    def gather(self, shards: Sequence[Tensor]) -> List[Tensor]:
        """New full tensors of ``shards`` (the replicated leaves as they are)."""
        fulls = list(shards)
        for i in self.sharded:
            fulls[i] = shards[i].new_empty(self.shapes[i])
        self.gather_(shards, fulls)
        return fulls

    @torch.no_grad()
    def reduce_gradients(self, grads: Sequence[Tensor], extra: Sequence[Tensor] = ()) -> List[Tensor]:
        """This rank's gradients of the full leaves (its rows of the global
        batch) -> the shards of their mean over the world: each sharded
        leaf reduce-scattered (SUM) inside the model group, all-reduced
        across the data group and divided by the world.  The replicated
        leaves' gradients and ``extra`` (the step's metrics) are replaced by
        their means over the world in place, in one all-reduce, and come
        back as they are."""
        from bio_diffusion_torch.parallel.distributed import all_reduce_mean_

        dp, out = self.dp, list(grads)
        for idx in self._by_dtype(grads):
            buf = torch.cat([grads[i].reshape(self._split(i)).movedim(self.dims[i], 0).reshape(self.model, -1)
                             for i in idx], dim=1)
            local = buf.new_empty(buf.shape[1])
            dist.reduce_scatter_tensor(local, buf.reshape(-1), op=dist.ReduceOp.SUM, group=dp.model_group)
            if dp.world > self.model:
                dist.all_reduce(local, op=dist.ReduceOp.SUM, group=dp.data_group)
            local.div_(dp.world)
            offset = 0
            for i in idx:
                k = self.shapes[i][self.dims[i]] // self.model
                shape = self.shapes[i][:self.dims[i]] + (k,) + self.shapes[i][self.dims[i] + 1:]
                n = grads[i].numel() // self.model
                out[i] = local[offset: offset + n].view(shape)
                offset += n
        all_reduce_mean_([grads[i] for i in self.replicated] + list(extra), dp)
        return out

    @torch.no_grad()
    def global_norm(self, shards: Sequence[Tensor]) -> Tensor:
        """The L2 norm of the full leaves from this rank's shards: the
        sharded leaves' squares summed over the model group, each
        replicated leaf counted once."""
        from bio_diffusion_torch.train.state import squared_norm

        device = shards[0].device
        total = squared_norm([shards[i] for i in self.sharded], device)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.dp.model_group)
        return torch.sqrt(total + squared_norm([shards[i] for i in self.replicated], device))
