"""Data parallelism: the counterpart of ``bio_diffusion_tpu/parallel/mesh.py``.

The JAX package shards each batch over the ``data`` axis of a device mesh
and XLA inserts the gradient psum.  Here training runs one process a card,
the ranks of a ``torch.distributed`` group launched by ``torchrun`` (the
reference's Lightning DDP over NCCL): every rank iterates the same global
batches and keeps its rows (``shard_rows``, JAX's ``P("data")``), and the
train step all-reduces its gradients and metrics explicitly
(``all_reduce_mean_``, the psum of the shard_map transpose).  Inference
can split a batch over the cards of one process instead, a replica on
each (``Replicas``; ``inference_devices`` says which cards, one unless
asked).

Backends: NCCL with one rank a card, gloo on the CPU (or, explicitly, over
CUDA tensors when two ranks share one card, which NCCL refuses; PyTorch's
gloo takes CUDA tensors, so nothing is staged through host memory here).

With ``num_model_shards = M > 1`` the group is also a ``data x model`` mesh
(``parallel/mesh.py``): the ranks of a model group share one copy of the
train state, each keeping its slices, and the step gathers the parameters
and reduce-scatters the gradients; the rows of a batch are still split
over the whole world.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
from collections import abc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bio_diffusion_torch.parallel.mesh import mesh_layout, new_mesh_groups

Tensor = torch.Tensor

# the longest a rank waits in a collective: the other ranks wait at a
# barrier while rank 0 runs the sampling evaluation
DEFAULT_TIMEOUT_S = 7200.0


@dataclasses.dataclass
class DataParallel:
    """This process's place in the data-parallel group: ``rank`` of
    ``world``, the card (or CPU) it computes on, the process group (None:
    the default one) and its backend; with ``model > 1`` the world is a
    ``data x model`` mesh (``parallel/mesh.py``) and ``model_group`` /
    ``data_group`` are this rank's row and column of it."""

    rank: int
    world: int
    device: torch.device
    group: Any = None
    backend: str = "gloo"
    model: int = 1
    model_group: Any = None
    data_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data(self) -> int:
        """The number of data groups: copies of the train state."""
        return self.world // self.model


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def launched_world() -> Optional[int]:
    """The world size a launcher set: torchrun's ``WORLD_SIZE``, else JAX's
    ``JAX_NUM_PROCESSES``; None without a launcher."""
    return _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")


def init_distributed(device_type: str = "cuda", backend: Optional[str] = None, device=None,
                     init_method: Optional[str] = None, rank: Optional[int] = None, world: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S, num_model_shards: int = 1) -> DataParallel:
    """Join the process group -> this rank's ``DataParallel`` record
    (counterpart of ``initialize_multihost``).

    Rank and world come from the arguments, else torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` (rendezvous at ``MASTER_ADDR`` /
    ``MASTER_PORT``), else JAX's ``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES``
    / ``JAX_COORDINATOR_ADDRESS``.  ``backend`` defaults to NCCL for
    ``device_type="cuda"`` and gloo for the CPU.  Without ``device``, a CUDA
    rank takes ``cuda:LOCAL_RANK`` and raises where two ranks of a host would
    share a card.  A group that is already up is joined as it is.

    ``num_model_shards = M`` lays the world out as ``W/M x M``
    (``mesh.mesh_layout``: one rank has no model axis, a world that ``M``
    does not divide raises ``ValueError``) and creates the model and data
    sub-groups (``mesh.new_mesh_groups``; every rank must call this)."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build")
    rank = rank if rank is not None else _env_int("RANK", "JAX_PROCESS_ID")
    world = world if world is not None else launched_world()
    if init_method is None and "MASTER_ADDR" not in os.environ and os.environ.get("JAX_COORDINATOR_ADDRESS"):
        init_method = f"tcp://{os.environ['JAX_COORDINATOR_ADDRESS']}"
    local_rank = _env_int("LOCAL_RANK")
    local_rank = local_rank if local_rank is not None else 0
    if device is None:
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("data parallel on cuda but no CUDA device is available (there is no CPU fallback)")
            count = torch.cuda.device_count()
            local_world = _env_int("LOCAL_WORLD_SIZE") or 1
            if local_rank >= count or local_world > count:
                raise RuntimeError(f"{max(local_world, local_rank + 1)} ranks on this host but {count} card(s): two "
                                   "ranks would share a card (launch at most one rank a card)")
            device = torch.device("cuda", local_rank)
        else:
            device = torch.device(device_type)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        kwargs: Dict[str, Any] = {"timeout": datetime.timedelta(seconds=float(timeout_s))}
        if init_method is not None:
            kwargs["init_method"] = init_method
        if rank is not None:
            kwargs["rank"] = rank
        if world is not None:
            kwargs["world_size"] = world
        dist.init_process_group(backend, **kwargs)
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        layout = mesh_layout(world, num_model_shards)
    except ValueError:
        shutdown()
        raise
    model_group = data_group = None
    if layout.model > 1:
        model_group, data_group = new_mesh_groups(layout, rank)
    return DataParallel(rank=rank, world=world, device=device, backend=dist.get_backend(), model=layout.model,
                        model_group=model_group, data_group=data_group)


def shutdown() -> None:
    """Leave the process group (where one is up)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# -- rows -------------------------------------------------------------------------


def row_slice(batch_size: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch: contiguous ``[r B/W, (r+1) B/W)``
    when the batch divides by ``world``, else the whole batch (JAX's
    replicated rule for a ragged final batch)."""
    if world <= 1 or batch_size % world:
        return slice(0, batch_size)
    k = batch_size // world
    return slice(rank * k, (rank + 1) * k)


def _is_scalar(a) -> bool:
    return isinstance(a, (bool, int, float)) or (isinstance(a, (Tensor, np.ndarray)) and a.ndim == 0)


def _leading(batch) -> int:
    if dataclasses.is_dataclass(batch):
        batch = [getattr(batch, f.name) for f in dataclasses.fields(batch)]
    if isinstance(batch, dict):
        batch = list(batch.values())
    if isinstance(batch, (list, tuple)):
        return next(_leading(v) for v in batch if v is not None and not _is_scalar(v))
    return int(batch.shape[0])


def _take(batch, sl: slice):
    if batch is None or _is_scalar(batch):
        return batch
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{f.name: _take(getattr(batch, f.name), sl)
                                             for f in dataclasses.fields(batch)})
    if isinstance(batch, dict):
        return {k: _take(v, sl) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_take(v, sl) for v in batch)
    return batch[sl]


def shard_rows(batch, rank: int, world: int):
    """Rank ``rank``'s rows (``row_slice``) of every leaf of ``batch`` (a
    tensor, an array, a dataclass such as ``DenseMolBatch``, a dict or a
    sequence; None leaves and scalars, such as a 0-dim tensor or a bool,
    stay whole) -- the counterpart of ``shard_batch``."""
    if batch is None:
        return None
    return _take(batch, row_slice(_leading(batch), rank, world))


# -- collectives --------------------------------------------------------------------


def _flat_reduce_(tensors: Sequence[Tensor], dp: DataParallel, op, mean: bool) -> List[Tensor]:
    tensors = list(tensors)
    if not tensors:
        return tensors
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, op=op, group=dp.group)
        if mean:
            flat.div_(dp.world)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset: offset + n].view(t.shape))
            offset += n
    return tensors


def all_reduce_mean_(tensors: Sequence[Tensor], dp: DataParallel) -> List[Tensor]:
    """Replace each tensor by its mean over the ranks, in place: one flat
    float32 buffer, ``SUM``, then a division by ``world`` -> the tensors."""
    return _flat_reduce_(tensors, dp, dist.ReduceOp.SUM, mean=True)


def all_reduce_max_(tensors: Sequence[Tensor], dp: DataParallel) -> List[Tensor]:
    """Replace each tensor by its elementwise maximum over the ranks, in place."""
    return _flat_reduce_(tensors, dp, dist.ReduceOp.MAX, mean=False)


def broadcast_(tensors: Sequence[Tensor], dp: DataParallel, src: int = 0) -> List[Tensor]:
    """Overwrite each tensor with rank ``src``'s, in place (one flat buffer
    a dtype) -> the tensors."""
    tensors = list(tensors)
    by_dtype: Dict[torch.dtype, List[Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src=src, group=dp.group)
            offset = 0
            for t in group:
                n = t.numel()
                t.copy_(flat[offset: offset + n].view(t.shape))
                offset += n
    return tensors


def broadcast_object(obj: Any, dp: DataParallel, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (any picklable value) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=dp.group,
                               device=dp.device if dp.backend == "nccl" else None)
    return box[0]


def barrier(dp: DataParallel) -> None:
    """Wait until every rank got here (bounded by the group's timeout)."""
    if dp.backend == "nccl":
        dist.barrier(group=dp.group, device_ids=[dp.device.index])
    else:
        dist.barrier(group=dp.group)


# -- inference devices -------------------------------------------------------------------


def inference_devices(cfg: Optional[Dict[str, Any]] = None, device=None) -> List[torch.device]:
    """The devices the inference CLIs split a batch over (counterpart of
    ``cli/common.py::inference_mesh``): ``[device]`` unless the config's
    ``inference_devices`` key asks for more cards, a count or ``all``
    (``device`` is then ``cuda`` without an index).  ``device`` defaults to
    the config's ``device`` key, then ``cuda``.

    One card is the default, where the JAX CLIs' ``use_mesh`` takes every
    device (the port reads no ``use_mesh`` here): on the H100 the split ran
    slower than one card at every batch measured (PERF.md section 5), since
    one thread issues every replica's eager launches."""
    cfg = cfg or {}
    device = torch.device(device if device is not None else str(cfg.get("device", "cuda")))
    want = str(cfg.get("inference_devices", 1)).lower()
    if want in ("1", "none"):
        return [device]
    if device.type != "cuda" or device.index is not None:
        raise ValueError(f"inference_devices={want} splits a batch over cards: give device=cuda (no index), "
                         f"not {device}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    k = count if want == "all" else int(want)
    if not 1 <= k <= count:
        raise ValueError(f"inference_devices={want}: {count} card(s) visible")
    return [torch.device("cuda", i) for i in range(k)]


class Replicas:
    """A copy of ``module`` on each of ``devices`` and the split of a
    batch's rows over them, built once: ``module`` itself serves the device
    it lies on (one device costs no copy), every other device gets one deep
    copy, shared by its repeated entries.  A batch of B rows is padded to a
    multiple of the device count with copies of its first row (the JAX
    package's rule), device i takes the i-th contiguous block of rows, and
    ``gather`` slices the padding off again."""

    def __init__(self, module: torch.nn.Module, devices: Optional[Sequence] = None):
        home = next(module.parameters()).device
        self.devices = [torch.device(d) for d in devices] if devices else [home]
        made: Dict[torch.device, torch.nn.Module] = {home: module}
        self.modules: List[torch.nn.Module] = []
        for d in self.devices:
            key = torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            if key not in made:
                made[key] = copy.deepcopy(module).to(d)
            self.modules.append(made[key])

    def __len__(self) -> int:
        return len(self.devices)

    def piece(self, a, b: int, i: int) -> Optional[Tensor]:
        """Device ``i``'s rows of ``a`` (a ``[b, ...]`` array or tensor; a
        ``[1, ...]`` one, shared by every row, goes whole; None stays None),
        on that device."""
        if a is None:
            return None
        if not isinstance(a, Tensor):
            a = torch.as_tensor(np.asarray(a, dtype=np.float32))
        if a.shape[0] != 1:
            nd = len(self.devices)
            pad = (-b) % nd
            if pad:
                a = torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
            k = (b + pad) // nd
            a = a[i * k: (i + 1) * k]
        return a.to(self.devices[i], non_blocking=True)

    def scatter(self, a, b: int) -> List[Optional[Tensor]]:
        """Every device's ``piece`` of ``a``."""
        return [self.piece(a, b, i) for i in range(len(self.devices))]

    @staticmethod
    def gather(outs: Sequence[Tensor], b: int) -> np.ndarray:
        """The replicas' outputs on the host (float32), in row order, the
        padding sliced off."""
        return np.concatenate([o.float().cpu().numpy() for o in outs])[:b]

    def draws(self, b: int, shape: Sequence[int], count: int, generator: Optional[torch.Generator] = None,
              noises: Optional[Sequence] = None) -> List["RowDraws"]:
        """Each replica's view of the ``count`` raw draws a one-device run
        makes: ``noises``, or draws of ``shape`` (``[b or 1, N, F]``) on the
        first device from ``generator`` (default: that device's default
        generator).  The first replica draws from ``generator`` itself, so
        it ends where the one-device run leaves it; every other draws from
        a copy of its state, so no draw is held longer than its step."""
        if noises is not None and len(noises) != count:
            raise ValueError(f"noises: need {count} draws, got {len(noises)}")
        gens: List[Optional[torch.Generator]] = [None] * len(self.devices)
        if noises is None:
            d0 = self.devices[0]
            if generator is None:
                generator = (torch.cuda.default_generators[d0.index if d0.index is not None else
                                                           torch.cuda.current_device()]
                             if d0.type == "cuda" else torch.default_generator)
            gens[0] = generator
            for i in range(1, len(gens)):
                gens[i] = torch.Generator(device=generator.device)
                gens[i].set_state(generator.get_state())
        return [RowDraws(self, i, b, tuple(shape), range(count), g, noises) for i, g in enumerate(gens)]

    def map(self, call: Callable, inputs: Sequence, draws: Optional[Sequence["RowDraws"]] = None) -> np.ndarray:
        """``call(module, its pieces of inputs, its draws)`` on each replica
        in turn -> the outputs' rows on the host (``gather``)."""
        b = next(a for a in inputs if a is not None).shape[0]
        return self.gather([call(m, [self.piece(a, b, i) for a in inputs], None if draws is None else draws[i])
                            for i, m in enumerate(self.modules)], b)


class RowDraws(abc.Sequence):
    """One replica's rows of a run's raw draws, made as they are read: item
    k is ``noises[k]``, or the next draw from the generator (read the drawn
    items in order, each once), as ``Replicas.piece`` cuts it.  A slice is
    a view that shares the generator."""

    def __init__(self, reps: Replicas, i: int, b: int, shape: Tuple[int, ...], index: range,
                 generator: Optional[torch.Generator], noises: Optional[Sequence]):
        self.reps, self.i, self.b, self.shape, self.index = reps, i, b, shape, index
        self.generator, self.noises = generator, noises

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, k):
        if isinstance(k, slice):
            return RowDraws(self.reps, self.i, self.b, self.shape, self.index[k], self.generator, self.noises)
        d0 = self.reps.devices[0]
        if self.noises is not None:
            raw = torch.as_tensor(self.noises[self.index[k]]).to(d0)
        else:
            raw = torch.randn(self.shape, generator=self.generator, device=d0, dtype=torch.float32)
        return self.reps.piece(raw, self.b, self.i)
