"""Process groups, the mesh value, the training window's rows and host
gathers (``fastspeech2_tpu/parallel/mesh.py``), on ``torch.distributed``.
Sharded inference (the JAX ``shard_inference_fn`` and
``shard_inference_fn_tp``) is ``Synthesizer(mesh=)`` (``infer/synthesize.py``).

One process drives one device. ``initialize_multihost`` forms the group
(``init_process_group``) from its arguments or from the variables
``torch.distributed.run`` sets; a world of one is a no-op. A ``Mesh`` takes
the place of ``jax.sharding.Mesh``: the ranks as a (dp, tp) grid, the model
axis minor (rank = data_index * tp + model_index), with one process group per
axis (the ranks that share this rank's model index form its data group; those
that share its data index, its model group). A mesh without a process group
is a LOCAL mesh: a list of devices one process serves shards on
(``infer/synthesize.py``), one thread a shard; a ``ThreadGroup`` takes the
place of the process group there, and the collectives below take either.

The data-parallel numerics follow the JAX package's global-batch semantics:
the training step enters ``data_shard`` around each micro-batch's forward,
and ``ops/nn.py`` (dropout masks over the global index, BatchNorm statistics
over the data group) and ``models/fastspeech2.py`` (loss denominators over
the data group) read it.

The backend is NCCL for CUDA devices and gloo for the CPU; gloo with CUDA
tensors is taken only when the caller names it (two ranks on one card, which
NCCL refuses). Gloo takes CUDA tensors for every collective used here (the
H100 box's torch 2.11 ran all-reduce, broadcast, both all-gathers,
reduce-scatter and the object collectives on them), so nothing is staged
through host memory. The tensor forms of all-gather and reduce-scatter are
named differently across torch releases (2.13 deprecates
``all_gather_into_tensor`` for ``all_gather_single``), so this module uses
the list form of ``all_gather``, and a reduce-scatter is an all-reduce
followed by this rank's chunk: the same sums at twice a true
reduce-scatter's traffic (sequence parallelism only).
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist


def default_backend(device: Union[str, torch.device, None]) -> str:
    """NCCL for a CUDA device (``None`` means the card), gloo for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    return "nccl" if dev.type == "cuda" else "gloo"


def local_device(device: Union[str, torch.device, None]) -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    ``cuda:LOCAL_RANK`` (modulo the visible cards, so several ranks can
    share one card under gloo)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         device: Union[str, torch.device, None] = None) -> int:
    """Join the process group; returns the world size.

    ``coordinator_address`` (``host:port`` or a URL), ``num_processes`` and
    ``process_id`` default to torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. A world of one forms no group. ``backend``
    defaults to ``default_backend(device)``: it is never changed behind the
    caller's back (NCCL is not swapped for gloo)."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world <= 1:
        return 1
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    backend = backend or default_backend(device)
    if local_device(device).type == "cuda":
        # the rank's card is current: NCCL's communicator and the kernels,
        # which launch on the current card, take it
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    return world


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass(eq=False)
class Mesh:
    """A (dp, tp) grid of ranks (``make_mesh``, ``make_mesh_2d``) or a local
    list of devices (``make_mesh(devices=...)``)."""

    devices: List[torch.device]
    dp: int
    tp: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    data_index: int = 0
    model_index: int = 0
    #: data-group ranks of this rank's model index, in data order
    data_ranks: List[int] = field(default_factory=list)

    def __deepcopy__(self, memo):  # a model's copy shares its mesh
        return self

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def distributed(self) -> bool:
        """One process per device (collectives), as opposed to a local mesh."""
        return self.data_group is not None or self.model_group is not None


def make_mesh_2d(dp: int, tp: int, device: Union[str, torch.device, None] = None) -> Mesh:
    """The (dp, tp) process mesh over the whole world, model axis minor
    (``sharding.py:146-158`` of the JAX package). Every rank must call it
    (group creation is collective); a world of one gives the trivial mesh."""
    world = world_size()
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} processes, the world "
                         f"has {world}")
    dev = local_device(device) if device is not None else torch.device("cpu")
    if world == 1:
        return Mesh([dev], 1, 1)
    r = rank()
    d, m = divmod(r, tp)
    data_group = model_group = None
    # new_group is collective over the WORLD: every rank creates every group
    # in the same order and keeps its own
    for mm in range(tp):
        ranks = [dd * tp + mm for dd in range(dp)]
        g = dist.new_group(ranks)
        if mm == m:
            data_group, data_ranks = g, ranks
    for dd in range(dp):
        g = dist.new_group([dd * tp + mm for mm in range(tp)])
        if dd == d:
            model_group = g
    return Mesh([dev], dp, tp, data_group if dp > 1 else None,
                model_group if tp > 1 else None, d, m, data_ranks)


def release(mesh: Optional[Mesh]) -> None:
    """Destroy the process groups ``make_mesh_2d`` created for ``mesh``."""
    if mesh is None:
        return
    for g in {id(g): g for g in (mesh.data_group, mesh.model_group)
              if g is not None and g is not dist.group.WORLD}.values():
        dist.destroy_process_group(g)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """1-D data mesh (``train/step.py:make_mesh`` of the JAX package). In a
    process group: over every rank (``n_devices``, when given, must be the
    world size). Without one: a local mesh over ``devices`` (entries may
    repeat: two shards on one card), else over the first ``n_devices``
    visible cards."""
    world = world_size()
    if world > 1:
        if n_devices not in (None, world) or devices is not None:
            raise ValueError(f"a data mesh spans the whole world ({world} "
                             "processes): one device per process")
        return make_mesh_2d(world, 1, device)
    if devices is None:
        n = torch.cuda.device_count() if n_devices is None else n_devices
        if n > torch.cuda.device_count():
            raise ValueError(f"mesh of {n} needs {n} cards, "
                             f"have {torch.cuda.device_count()}")
        devices = [f"cuda:{i}" for i in range(max(n, 1))]
    devs = [torch.device(d) for d in devices]
    return Mesh(devs, len(devs))


# -- a group of threads ---------------------------------------------------------

# The longest a thread of a ThreadGroup waits for the others at one collective.
_BARRIER_TIMEOUT_S = 600.0


class ThreadGroup:
    """``size`` threads of one process as a collective group: the shards of
    one call over a local mesh (``infer/synthesize.py``), one thread each.

    A collective is a rendezvous: each thread puts its tensor in its slot and
    waits at the barrier; each then computes the result from every slot on
    its own device (a tensor on another card is copied there, and PyTorch
    orders a copy between cards after the work on both cards' current
    streams) and waits again, so that no slot is overwritten while another
    thread still reads it; an all-reduce writes its result in place after
    that. Every thread computes the same ops on the same inputs in rank
    order, so all of them hold the same bits. Every wait is bounded by
    ``_BARRIER_TIMEOUT_S``; ``abort`` (a thread that failed) breaks the barrier
    and every waiting or later wait raises ``threading.BrokenBarrierError``."""

    def __init__(self, size: int):
        self.size = size
        self._barrier = threading.Barrier(size, timeout=_BARRIER_TIMEOUT_S)
        self._slots: List[Optional[torch.Tensor]] = [None] * size

    def rank(self, r: int) -> "ThreadRank":
        return ThreadRank(self, r)

    def abort(self) -> None:
        self._barrier.abort()

    def _combine(self, r: int, t: torch.Tensor, fn) -> torch.Tensor:
        self._slots[r] = t
        self._barrier.wait()
        out = fn([s.to(t.device) for s in self._slots])
        self._barrier.wait()
        return out

    def all_reduce(self, r: int, t: torch.Tensor, op) -> torch.Tensor:
        if op not in (dist.ReduceOp.SUM, dist.ReduceOp.MAX):
            raise ValueError(f"a thread group reduces by SUM or MAX, not {op}")
        reduce = torch.sum if op == dist.ReduceOp.SUM else torch.amax
        t.copy_(self._combine(r, t, lambda ts: reduce(torch.stack(ts), dim=0)))
        return t

    def all_gather(self, r: int, t: torch.Tensor, dim: int) -> torch.Tensor:
        return self._combine(r, t, lambda ts: torch.cat(ts, dim=dim))


@dataclass(frozen=True)
class ThreadRank:
    """One thread's place in a ``ThreadGroup``: the group a local mesh's
    data shard hands the collectives."""

    group: ThreadGroup
    rank: int


# -- collectives ---------------------------------------------------------------

def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over a process group or a ``ThreadRank``'s
    group; returns ``t``."""
    if isinstance(group, ThreadRank):
        return group.group.all_reduce(group.rank, t, op)
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    rank order."""
    if group is None:
        return t
    if isinstance(group, ThreadRank):
        return group.group.all_gather(group.rank, t, dim)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank of the world (a collective)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal chunk of ``t`` along ``dim``."""
    if group is None:
        return t
    size = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * size, size)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, differentiable: the cotangent of each rank's
    input is the sum of every rank's cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (identity for ``None``)."""
    return x if group is None else _AllReduceSum.apply(x, group)


# -- the training step's data shard ------------------------------------------

@dataclass(frozen=True)
class DataShard:
    """This rank's part of a global micro-batch: rows ``[row0, row0 + n)``
    of ``rows``; ``sequence_parallel`` splits the FFT-block residual streams
    on time over the model group (``models/encoder.py``). A shard of a
    local mesh is a thread: ``threads`` gives its data index and its call's
    group; a process mesh's shard takes both from the mesh."""

    mesh: Mesh
    row0: int
    rows: int
    sequence_parallel: bool = False
    threads: Optional[ThreadRank] = None

    @property
    def group(self):
        return self.threads if self.threads is not None else self.mesh.data_group

    @property
    def data_index(self) -> int:
        return self.threads.rank if self.threads is not None else self.mesh.data_index

    @property
    def shard_index(self) -> int:
        """The JAX package's per-shard kernel index: data * tp + model."""
        return self.data_index * self.mesh.tp + self.mesh.model_index


_SHARD = threading.local()


def current_shard() -> Optional[DataShard]:
    return getattr(_SHARD, "shard", None)


@contextlib.contextmanager
def data_shard(shard: Optional[DataShard]):
    """Thread-local: the forward inside runs as ``shard`` of a global
    micro-batch (``None``: a whole batch on one device). Its readers sit at
    the leaves (every dropout site, the postnet's BatchNorm, the loss), so a
    context takes the place of a shard argument on every module's forward;
    a remat replay and the autograd thread re-enter it
    (``models/encoder.py:replayed_block``)."""
    prev = getattr(_SHARD, "shard", None)
    _SHARD.shard = shard
    try:
        yield
    finally:
        _SHARD.shard = prev


def data_total(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sums over the active shard's data group of a few scalars, in one
    all-reduce and without gradient (loss denominators); the values as they
    are outside a shard."""
    sh = current_shard()
    if sh is None or sh.group is None:
        return list(values)
    with torch.no_grad():
        t = torch.stack([v.detach().float() for v in values])
        all_reduce(t, sh.group)
    return list(t.unbind(0))


# -- batches and host copies ----------------------------------------------------

def window_rows(mesh: Optional[Mesh], accum: int, micro_rows: int) -> np.ndarray:
    """The rows of the global accumulation window this rank computes:
    micro-batch ``i`` is the window's rows ``[i * micro_rows, (i + 1) *
    micro_rows)`` (the JAX step's reshape), and data index ``d`` takes its
    ``d``-th contiguous share of each, so the local batch is ``accum``
    contiguous micro-batches of ``micro_rows // dp`` rows."""
    dp = mesh.dp if mesh is not None else 1
    if micro_rows % dp:
        raise ValueError(f"{dp} data shards do not divide a micro-batch of "
                         f"{micro_rows} rows")
    m = micro_rows // dp
    d = mesh.data_index if mesh is not None else 0
    return np.concatenate([np.arange(i * micro_rows + d * m,
                                     i * micro_rows + (d + 1) * m)
                           for i in range(accum)])


def gather_to_host(tensors: Mapping[str, torch.Tensor], mesh: Optional[Mesh],
                   shard_dims: Optional[Mapping[str, Optional[int]]] = None
                   ) -> Dict[str, np.ndarray]:
    """Numpy copies of the full state on EVERY rank: a collective every rank
    calls. ``shard_dims[name]``: the dim a tensor is split along over the
    model group (``None`` or absent: replicated, copied as it is)."""
    out = {}
    group = mesh.model_group if mesh is not None else None
    for name, t in tensors.items():
        d = (shard_dims or {}).get(name)
        t = t.detach()
        if d is not None and group is not None:
            t = all_gather(t, group, dim=d)
        out[name] = t.cpu().numpy()
    return out

