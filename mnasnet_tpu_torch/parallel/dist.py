"""Data-parallel training over processes, one per GPU: the process group, the
replica handle and the collectives of the port.

Counterpart of ``mnasnet_tpu/parallel/mesh.py`` and of the root ``train.py``'s
``maybe_init_distributed`` (:207-226) and world checks (:310-317). The
reference shards one global batch over a ``('data',)`` mesh, keeps the
parameters, statistics and optimizer state replicated, and lets GSPMD insert
the collectives. Here each process holds its shard of the batch and a full
replica of the state, and the code names each collective:

  * sync-BN: the BN moments of the forward and the BN sums of the backward
    are summed over the replicas (``ops/cuda/bn_bwd.py``, ``models/layers.py``);
  * the step: the global count of valid labels, then one flat buffer of the
    gradients, the loss and the top-k counts (``train/steps.py``);
  * the trainer: a stop flag per step, the validation sums, a barrier after
    each checkpoint.

Only ``all_reduce`` and ``broadcast`` are used, so the same code runs over
NCCL and over gloo, which carries CUDA tensors for those two only. A
``Replicas`` handle of ``None`` means one process: every helper is then a
no-op that launches nothing. Each helper adds one to ``Replicas.collectives``
for each collective it issues (the backward of :func:`all_reduce_sum` too),
so a run can be held to the number the code predicts.

``--mesh-dcn N`` (multi-slice) adds no code path: NCCL's topology already
reduces within a node before it crosses nodes, which is what the reference's
``('dcn', 'data')`` axes give GSPMD. Spatial partitioning (``spatial``) is
not ported.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist


class ReplicaMismatch(RuntimeError):
    """State that should be the same on every replica is not."""


class Replicas:
    """The data-parallel replicas of a run: ``group`` (None: the default
    group), this process's ``rank``, the ``world`` size and this rank's
    ``device``. ``collectives`` counts the collectives the helpers issued."""

    def __init__(self, rank: int, world: int, device, group=None):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.group = group
        self.collectives = 0
        self.tape: Optional[SumTape] = None
        self._rows_checked: set[int] = set()

    def __repr__(self) -> str:
        return f"Replicas(rank={self.rank}, world={self.world}, device={self.device})"


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_distributed(dist_url: Optional[str] = None, world: int = -1, rank: int = -1,
                     backend: Optional[str] = None, device="cuda") -> Optional[Replicas]:
    """Join the default process group when this process is one of several.

    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) is taken when it is set; otherwise
    ``dist_url`` (``tcp://host:port``, ``file:///path`` or ``env://``) with
    ``world > 1`` and ``rank``, as the reference's ``--dist-url``. With
    neither, returns None: one process. The backend is ``nccl`` on a CUDA
    device and ``gloo`` on the CPU, unless ``backend`` names one. A CUDA rank
    runs on ``cuda:LOCAL_RANK`` (``rank`` modulo the cards when there is no
    ``LOCAL_RANK``) unless ``device`` names an index."""
    if "WORLD_SIZE" in os.environ:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif dist_url and world > 1:
        if rank < 0:
            raise ValueError(f"--dist-url {dist_url} with world size {world} needs this "
                             "process's --rank")
        init_method = dist_url
    else:
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return Replicas(rank, world, dev)


def close(replicas: Optional[Replicas]) -> None:
    """Leave the default group that :func:`init_distributed` joined."""
    if replicas is not None and dist.is_initialized():
        dist.destroy_process_group()


def _flat_buffer(tensors: list[torch.Tensor], dtype, device) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(device=device, dtype=dtype) for t in tensors])


def _scatter_back_(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def all_reduce_sum_(tensors: Iterable[torch.Tensor], replicas: Optional[Replicas]) -> None:
    """Sum each tensor over the replicas, in place, with one collective. One
    contiguous fp32 tensor is reduced where it lies; several (of any dtype
    that fp32 holds exactly, such as counts) go through one flat fp32
    buffer on the replica's device and back."""
    if replicas is None:
        return
    tensors = list(tensors)
    if (len(tensors) == 1 and tensors[0].dtype == torch.float32
            and tensors[0].is_contiguous() and tensors[0].device == replicas.device):
        flat = tensors[0]
        dist.all_reduce(flat, group=replicas.group)
        replicas.collectives += 1
        return
    flat = _flat_buffer(tensors, torch.float32, replicas.device)
    dist.all_reduce(flat, group=replicas.group)
    replicas.collectives += 1
    _scatter_back_(flat, tensors)


class _AllReduceSum(torch.autograd.Function):
    """``torch.distributed.nn.functional.all_reduce`` for a sum (deprecated in
    this PyTorch, with a warning on every call), counting its collectives:
    the forward sums a copy of the tensor over the replicas, the backward
    sums a copy of the gradient."""

    @staticmethod
    def forward(ctx, t, replicas):
        ctx.replicas = replicas
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=replicas.group)
        replicas.collectives += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.replicas), None


class _Replayed(torch.autograd.Function):
    """A sum a :class:`SumTape` recorded, in place of :class:`_AllReduceSum`
    on the same ``t``: the forward returns a copy of the recorded sum and
    issues nothing, the backward is ``_AllReduceSum``'s."""

    @staticmethod
    def forward(ctx, t, recorded, replicas):
        if recorded.shape != t.shape:
            raise RuntimeError(f"the replayed sum has shape {tuple(recorded.shape)}, the "
                               f"tensor {tuple(t.shape)}: the region ran otherwise")
        ctx.replicas = replicas
        return recorded.clone()

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.replicas), None, None


class SumTape:
    """The sums :func:`all_reduce_sum` gave in the first run of a region
    (:func:`taped_sums`), in order, for each later run of the same region to
    take in turn without a collective: the recompute of a rematerialised
    block under sync-BN normalises with exactly the global moments its
    forward used and issues no collective of its own."""

    def __init__(self):
        self.sums: Optional[list[torch.Tensor]] = None
        self.replaying = False
        self._next = 0

    def take(self) -> torch.Tensor:
        if self._next >= len(self.sums):
            raise RuntimeError("the region asked for more sums than its first run made")
        self._next += 1
        return self.sums[self._next - 1]


@contextlib.contextmanager
def taped_sums(replicas: Optional[Replicas], tape: SumTape):
    """Within: the first run records the sums of :func:`all_reduce_sum`
    into ``tape``, every later run replays them (no collective, nothing
    counted). A no-op without replicas."""
    if replicas is None:
        yield
        return
    tape.replaying = tape.sums is not None
    if not tape.replaying:
        tape.sums = []
    tape._next = 0
    previous, replicas.tape = replicas.tape, tape
    try:
        yield
    finally:
        replicas.tape = previous


def all_reduce_sum(t: torch.Tensor, replicas: Optional[Replicas]) -> torch.Tensor:
    """The sum of ``t`` over the replicas as a new tensor, differentiable: the
    backward sums the gradient over the replicas again, one collective each
    way. Inside :func:`taped_sums` the sum is recorded, or replayed."""
    if replicas is None:
        return t
    tape = replicas.tape
    if tape is not None and tape.replaying:
        return _Replayed.apply(t, tape.take(), replicas)
    out = _AllReduceSum.apply(t, replicas)
    if tape is not None:
        tape.sums.append(out.detach())
    return out


def all_reduce_max_(t: torch.Tensor, replicas: Optional[Replicas]) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the replicas, in place."""
    if replicas is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=replicas.group)
        replicas.collectives += 1
    return t


class Flag:
    """A boolean agreed over the replicas (true if it is true on any), issued
    without waiting: :meth:`get` reads it. On a CUDA device the result is
    copied to pinned host memory behind an event, so reading it waits for
    the collective alone, not for work issued after it."""

    def __init__(self, value: bool, replicas: Optional[Replicas]):
        self._host = None
        self._event = None
        if replicas is None:
            self._value = value
            return
        t = torch.tensor([float(value)], device=replicas.device)
        all_reduce_max_(t, replicas)
        if t.device.type == "cuda":
            self._host = torch.empty(1, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def get(self) -> bool:
        if self._host is None:
            return self._value
        if self._event is not None:
            self._event.synchronize()
        return bool(self._host[0] > 0)


def barrier(replicas: Optional[Replicas]) -> None:
    """Return when every replica has reached this call: an all-reduce of one
    element, read on the host."""
    if replicas is not None:
        t = torch.ones(1, device=replicas.device)
        all_reduce_sum_([t], replicas)
        t.item()


def broadcast_(tensors: Iterable[torch.Tensor], replicas: Optional[Replicas],
               src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, in place: one broadcast for
    each dtype among them, through a flat buffer."""
    if replicas is None:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        flat = _flat_buffer(group, dtype, replicas.device)
        dist.broadcast(flat, src, group=replicas.group)
        replicas.collectives += 1
        _scatter_back_(flat, group)


def state_tensors(model: torch.nn.Module, tx=None) -> list[torch.Tensor]:
    """The tensors of a replica's state: the model's parameters and buffers,
    and the optimizer's (its slots and model-EMA shadow)."""
    out = list(model.state_dict().values())
    return out + (tx.tensors() if tx is not None else [])


def broadcast_state_(model: torch.nn.Module, tx, replicas: Optional[Replicas]) -> None:
    """Make the model's and the optimizer's state rank 0's on every replica."""
    broadcast_(state_tensors(model, tx), replicas)


def broadcast_seed(seed: int, replicas: Optional[Replicas]) -> int:
    """Rank 0's seed (``train.py:292-299``): a seed taken from the clock may
    differ between processes, and the shuffle, the augmentation and the
    dropout masks need one seed everywhere."""
    if replicas is None:
        return seed
    t = torch.tensor([seed], dtype=torch.int64, device=replicas.device)
    broadcast_([t], replicas)
    return int(t.item())


def assert_replicated(tensors: Iterable[torch.Tensor], replicas: Optional[Replicas],
                      what: str) -> None:
    """Raise unless ``tensors`` hold on every replica what they hold on rank 0,
    as far as one float64 sum per tensor tells: each rank's sums against rank
    0's, broadcast."""
    if replicas is None:
        return
    sums = torch.stack([t.detach().to(replicas.device, torch.float64).sum() for t in tensors])
    mine = sums.clone()
    broadcast_([sums], replicas)
    if not torch.equal(mine, sums):
        bad = int((mine != sums).nonzero()[0, 0])
        raise ReplicaMismatch(f"{what} differs between rank 0 and rank {replicas.rank} "
                           f"(tensor {bad} of {len(mine)})")


def global_rows(m: int, replicas: Optional[Replicas]) -> int:
    """The rows of a BN plane summed over the replicas, ``m`` on each: the
    count that sync-BN's moments and its backward divide by. Sync-BN takes
    the same shape on every replica (the loader gives it; the reference's
    sharded global batch has it too), so the count is ``m·world``, known to
    the host without a collective. The first time a value of ``m`` is seen
    it is checked, with one collective read on the host: Σm and Σm² over the
    replicas equal ``m·world`` and ``m²·world`` only when every replica has
    ``m`` rows."""
    if replicas is None:
        return m
    if m not in replicas._rows_checked:
        t = torch.tensor([float(m), float(m) * m], dtype=torch.float64, device=replicas.device)
        dist.all_reduce(t, group=replicas.group)
        replicas.collectives += 1
        if t.tolist() != [float(m) * replicas.world, float(m) * m * replicas.world]:
            raise ValueError(f"sync-BN needs the same batch shape on every replica; rank "
                             f"{replicas.rank} has {m} rows per channel, the replicas "
                             f"{t.tolist()[0]:.0f} in all")
        replicas._rows_checked.add(m)
    return m * replicas.world
