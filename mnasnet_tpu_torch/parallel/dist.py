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
so a run can be held to the number the code predicts. A helper counts when
it runs: eagerly, or once while a CUDA graph captures it; a replay of the
graph issues the captured collectives again without counting them.

Capture (the train step's graph route over NCCL, ``utils/routing.py``):
the helpers the step reaches (:func:`all_reduce_sum_`, :func:`all_reduce_sum`
and its backward, the replayed sums of :func:`taped_sums`,
:func:`all_reduce_max_`, :func:`global_rows` for a size it has seen) issue
device work only, so a capture records them; NCCL runs each on the group's
own stream, joined to the captured stream by events. The one host read,
:func:`global_rows`' first check of a plane size, belongs to the eager
warm-up step, and raises inside a capture. A gloo collective runs on the
host and cannot be captured (``Replicas.backend``). NCCL frees a
communicator only once every CUDA graph that captured its collectives is
gone, so a capture registers its graph (``Replicas.add_graph``) and
:func:`close` resets each before it leaves the group.

Failure (a dead or stalled peer): every wait at a collective is bounded.
The group is made with ``timeout=`` :func:`dist_timeout` (``DIST_TIMEOUT_S``
unless ``MNASNET_TPU_TORCH_DIST_TIMEOUT`` names other seconds). Over gloo a
collective that a dead peer's closed socket or the timeout ends raises in
the call; the helpers then mark the replicas failed
(``Replicas.failed``) and raise :class:`CollectiveFailed` naming this rank
and the collective. Over NCCL a collective is only enqueued, and the host
waits later (on an event, a copy to the host) for a result that a dead
peer never completes. The process group's watchdog times the eagerly
issued collectives out, but on H100s it caught the timeout and did not end
the process (PERF.md), and it never sees a collective replayed from a CUDA
graph. So an NCCL group gets a :class:`Deadline` of the host's own: each
eager collective, and each replay of a graph that holds collectives
(:meth:`Replicas.watch`, called by ``utils/routing.py:TrainRouted``),
records a CUDA event behind it, and a thread ends the process (one line,
exit 1) when one has not completed within the timeout. Whatever the host
then blocks in, a copy to the host or a synchronize behind a replay that
spins on a dead peer, an event behind that replay is pending.
:func:`close` leaves a failed group by abort, which waits on nothing.

Meshes (``parallel/mesh.py``): :func:`~mnasnet_tpu_torch.parallel.mesh.
use_mesh` lays the ranks out as the reference's ``dcn × data × spatial``
mesh (``Replicas.mesh``). A ``dcn`` axis changes no collective: NCCL's
topology already reduces within a node before it crosses nodes, which is
what the reference's ``('dcn', 'data')`` axes give GSPMD. A ``spatial``
axis splits each image's rows into bands over the ranks of a spatial
group (``parallel/spatial.py``): the halo exchanges and the pooled
features are summed over the group's subgroup (``Replicas.spatial_group``),
everything else stays world-wide, and :func:`global_rows` takes sync-BN's
counts from the static band plan.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import faulthandler
import os
import threading
import time
import weakref
from typing import Iterable, Optional

import torch
import torch.distributed as dist


# The bound on every wait at a collective of the port's process group, in
# seconds. What it bounds is the skew between ranks: how long one rank
# waits at a collective for its slowest peer. Every rank issues the same
# collectives and leaves each one when the last peer arrives, so a healthy
# skew is at most the longest stretch of work between two collectives, and
# is mostly much less: the ranks hold equal shards of the same batches.
# The longest stretch is the validation pass before its sums, which grows
# with the validation set: at ImageNet's 50,000 images over two ranks, 35 s
# at the data path's measured 710 images/s a rank (PERF.md). Other
# stretches are short: a step, a checkpoint save before its barrier, the
# first step's kernel build (~20 s on a fresh machine). 120 s is over 3
# times the longest, and short enough that the survivor of a dead peer
# exits within the reference's 300 s.
DIST_TIMEOUT_S = 120.0
TIMEOUT_ENV = "MNASNET_TPU_TORCH_DIST_TIMEOUT"


class ReplicaMismatch(RuntimeError):
    """State that should be the same on every replica is not."""


class CollectiveFailed(RuntimeError):
    """A collective raised: a peer died (its socket closed), stalled past the
    group's timeout, or the group failed otherwise."""


class Deadline:
    """The host's bound on the collectives of an NCCL group: each eager
    collective, and each replay of a graph that holds some, records a CUDA
    event behind it (:meth:`issued`), and a daemon thread checks every
    ``POLL_S`` whether the oldest has completed (``query``, which never
    blocks). Once one is ``limit_s`` old and not complete, or a query
    raises, the thread writes every thread's stack and one line to stderr
    and calls ``exit(1)`` (``os._exit``: the main thread may be blocked in
    a CUDA call for good)."""

    POLL_S = 1.0

    def __init__(self, rank: int, device, limit_s: float, exit=os._exit):
        self.rank = rank
        self.limit_s = limit_s
        self._device = device
        self._exit = exit
        self._pending: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="collective-deadline",
                                        daemon=True)
        self._thread.start()

    def issued(self, event, what: str) -> None:
        self._pending.append((time.monotonic(), event, what))

    def _run(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while not self._stop.wait(self.POLL_S):
            try:
                while self._pending and self._pending[0][1].query():
                    self._pending.popleft()
            except RuntimeError as e:  # the context failed: nothing will complete
                self._end(f"{self._pending[0][2]} cannot be queried ({e})")
                return
            if self._pending:
                at, _, what = self._pending[0]
                age = time.monotonic() - at
                if age > self.limit_s:
                    self._end(f"{what} has not completed {age:.0f} s after it was "
                              "issued (a dead or stalled peer)")
                    return

    def _end(self, why: str) -> None:
        faulthandler.dump_traceback(all_threads=True)
        os.write(2, f"[rank {self.rank}] {why}; exiting\n".encode())
        self._exit(1)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


class Replicas:
    """The data-parallel replicas of a run: ``group`` (None: the default
    group), this process's ``rank``, the ``world`` size and this rank's
    ``device``. ``collectives`` counts the collectives the helpers issued;
    :attr:`backend` names the group's backend. ``failed`` is None until a
    collective raises, then says which and why. ``deadline`` is the
    :class:`Deadline` of an NCCL group (None otherwise)."""

    def __init__(self, rank: int, world: int, device, group=None):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.group = group
        self.collectives = 0
        self.failed: Optional[str] = None
        self.deadline: Optional[Deadline] = None
        self.tape: Optional[SumTape] = None
        # The mesh (parallel/mesh.py:use_mesh): None is the flat data mesh.
        self.mesh = None
        self.spatial_group = None
        self.spatial_counts: dict[int, int] = {}
        self.spatial_planes: dict[tuple[int, int], int] = {}
        self._rows_checked: set[int] = set()
        self._graphs: weakref.WeakSet = weakref.WeakSet()

    @property
    def backend(self) -> str:
        """The group's backend, ``"nccl"`` or ``"gloo"``."""
        return str(dist.get_backend(self.group))

    def add_graph(self, graph) -> None:
        """Register a ``torch.cuda.CUDAGraph`` that captures (or is about to
        capture) this group's collectives: :func:`close` resets it."""
        self._graphs.add(graph)

    def watch(self, what: str) -> None:
        """Put an event behind the work the current stream has been given so
        far, for the :class:`Deadline` (if any) to hold to the timeout:
        after an eager collective, and after each replay of a graph that
        holds collectives, which no watchdog sees. Nothing while the stream
        captures."""
        if self.deadline is not None and not _capturing():
            event = torch.cuda.Event()
            event.record()
            self.deadline.issued(event, what)

    def __repr__(self) -> str:
        return f"Replicas(rank={self.rank}, world={self.world}, device={self.device})"


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def dist_timeout() -> float:
    """The seconds every collective may wait: ``MNASNET_TPU_TORCH_DIST_TIMEOUT``
    when it is set, else ``DIST_TIMEOUT_S``."""
    return float(os.environ.get(TIMEOUT_ENV, DIST_TIMEOUT_S))


def init_distributed(dist_url: Optional[str] = None, world: int = -1, rank: int = -1,
                     backend: Optional[str] = None, device="cuda",
                     timeout: Optional[float] = None) -> Optional[Replicas]:
    """Join the default process group when this process is one of several.

    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) is taken when it is set; otherwise
    ``dist_url`` (``tcp://host:port``, ``file:///path`` or ``env://``) with
    ``world > 1`` and ``rank``, as the reference's ``--dist-url``. With
    neither, returns None: one process. The backend is ``nccl`` on a CUDA
    device and ``gloo`` on the CPU, unless ``backend`` names one. A CUDA rank
    runs on ``cuda:LOCAL_RANK`` (``rank`` modulo the cards when there is no
    ``LOCAL_RANK``) unless ``device`` names an index. Every collective of the
    group waits at most ``timeout`` seconds (default :func:`dist_timeout`);
    an NCCL group also gets the host's :class:`Deadline` on the same
    bound."""
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
    seconds = dist_timeout() if timeout is None else float(timeout)
    join_group(backend, init_method, world, rank, seconds)
    replicas = Replicas(rank, world, dev)
    if backend == "nccl":
        replicas.deadline = Deadline(rank, dev, seconds)
    return replicas


def join_group(backend: str, init_method: str, world: int, rank: int,
               timeout: Optional[float] = None) -> None:
    """``init_process_group`` with every collective's wait bounded by
    ``timeout`` seconds (default :func:`dist_timeout`)."""
    seconds = dist_timeout() if timeout is None else float(timeout)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=seconds))


def close(replicas: Optional[Replicas]) -> None:
    """Leave the default group that :func:`init_distributed` joined.

    NCCL destroys a communicator only once every CUDA graph that captured
    its collectives is destroyed, and waits for that. A graph outlives its
    step wherever something still refers to it: a step held by the caller,
    a reference cycle not yet collected, or the traceback of an exception
    in flight through this call. So each graph registered with
    :meth:`Replicas.add_graph` is reset first, whoever holds it; a step
    whose graph was reset raises if it is called again. After a collective
    failed (``Replicas.failed``) the group is aborted instead of destroyed:
    a destroy may wait on the peer that is gone."""
    if replicas is not None and replicas.deadline is not None:
        replicas.deadline.stop()
        replicas.deadline = None
    if replicas is not None and dist.is_initialized():
        for graph in list(replicas._graphs):
            graph.reset()
        if replicas.failed is not None:
            from torch.distributed.distributed_c10d import _abort_process_group

            _abort_process_group()
        else:
            dist.destroy_process_group()


def _issue(replicas: Replicas, what: str, collective, *args, group=None, **kwargs) -> None:
    """Issue one collective of ``replicas``' group (or of its subgroup
    ``group``) and count it, or mark the replicas failed and raise
    :class:`CollectiveFailed` naming this rank and ``what``; an NCCL group's
    :class:`Deadline` watches it."""
    try:
        collective(*args, group=replicas.group if group is None else group, **kwargs)
    except RuntimeError as e:
        replicas.failed = f"{what} failed: {(str(e).splitlines() or [repr(e)])[0]}"
        raise CollectiveFailed(f"rank {replicas.rank}: {replicas.failed}") from e
    replicas.collectives += 1
    replicas.watch(what)


def _flat_buffer(tensors: list[torch.Tensor], dtype, device) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(device=device, dtype=dtype) for t in tensors])


def _scatter_back_(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def all_reduce_sum_(tensors: Iterable[torch.Tensor], replicas: Optional[Replicas],
                    what: str = "all_reduce") -> None:
    """Sum each tensor over the replicas, in place, with one collective
    (named ``what`` if it fails). One contiguous fp32 tensor is reduced
    where it lies; several (of any dtype that fp32 holds exactly, such as
    counts) go through one flat fp32 buffer on the replica's device and
    back, a float64 buffer when one of them is float64."""
    if replicas is None:
        return
    tensors = list(tensors)
    if (len(tensors) == 1 and tensors[0].dtype == torch.float32
            and tensors[0].is_contiguous() and tensors[0].device == replicas.device):
        _issue(replicas, what, dist.all_reduce, tensors[0])
        return
    wide = any(t.dtype == torch.float64 for t in tensors)
    flat = _flat_buffer(tensors, torch.float64 if wide else torch.float32, replicas.device)
    _issue(replicas, what, dist.all_reduce, flat)
    _scatter_back_(flat, tensors)


class _AllReduceSum(torch.autograd.Function):
    """``torch.distributed.nn.functional.all_reduce`` for a sum (deprecated in
    this PyTorch, with a warning on every call), counting its collectives:
    the forward sums a copy of the tensor over the replicas (or over their
    subgroup ``group``), the backward sums a copy of the gradient."""

    @staticmethod
    def forward(ctx, t, replicas, group=None):
        ctx.replicas, ctx.group = replicas, group
        out = t.clone(memory_format=torch.contiguous_format)
        what = "all_reduce (sync-BN)" if group is None else "all_reduce (pooled features)"
        _issue(replicas, what, dist.all_reduce, out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.replicas, ctx.group), None, None


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


def all_reduce_sum(t: torch.Tensor, replicas: Optional[Replicas],
                   group=None) -> torch.Tensor:
    """The sum of ``t`` over the replicas (or over their subgroup ``group``)
    as a new tensor, differentiable: the backward sums the gradient over
    them again, one collective each way. Inside :func:`taped_sums` the sum
    is recorded, or replayed."""
    if replicas is None:
        return t
    tape = replicas.tape
    if tape is not None and tape.replaying:
        return _Replayed.apply(t, tape.take(), replicas)
    out = _AllReduceSum.apply(t, replicas, group)
    if tape is not None:
        tape.sums.append(out.detach())
    return out


def all_reduce_max_(t: torch.Tensor, replicas: Optional[Replicas],
                    what: str = "all_reduce (max)") -> torch.Tensor:
    """The elementwise maximum of ``t`` over the replicas, in place."""
    if replicas is not None:
        _issue(replicas, what, dist.all_reduce, t, op=dist.ReduceOp.MAX)
    return t


class Flag:
    """A boolean agreed over the replicas (true if it is true on any), issued
    without waiting: :meth:`get` reads it. On a CUDA device nothing in the
    issue waits for the card (the value is filled in on the device, not
    copied from pageable host memory, which would wait for the stream), and
    the result is copied to pinned host memory behind an event, so reading
    it waits for the collective alone, not for work issued after it."""

    def __init__(self, value: bool, replicas: Optional[Replicas]):
        self._host = None
        self._event = None
        if replicas is None:
            self._value = value
            return
        t = torch.full((1,), float(value), device=replicas.device)
        all_reduce_max_(t, replicas, "all_reduce (the stop flag)")
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
        all_reduce_sum_([t], replicas, "all_reduce (barrier)")
        t.item()


def gather_int(value: int, replicas: Optional[Replicas], what: str) -> list[int]:
    """Every rank's ``value``, by rank, on every rank: one all-reduce of a
    vector that holds this rank's value at its own index (float64 holds
    integers exactly to 2^53)."""
    if replicas is None:
        return [value]
    t = torch.zeros(replicas.world, dtype=torch.float64, device=replicas.device)
    t[replicas.rank] = value
    _issue(replicas, what, dist.all_reduce, t)
    return [int(v) for v in t.tolist()]


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
        _issue(replicas, "broadcast", dist.broadcast, flat, src)
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


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False where
    this PyTorch sees no card)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def global_rows(m: int, replicas: Optional[Replicas]) -> int:
    """The rows of a BN plane summed over the replicas, ``m`` on this one: the
    count that sync-BN's moments and its backward divide by.

    Under a spatial mesh the bands of a plane may differ in height (a 7-row
    plane over 2 ranks: 4 and 3), so the count is the band plan's: Σ over
    the ranks of band rows × W × local N, recorded by the model for every
    plane of its forward (``parallel/mesh.py:register_planes``). Nothing is
    read on the host, so a capture takes any size. Otherwise sync-BN takes
    the same shape on every replica (the loader gives it; the reference's
    sharded global batch has it too), so the count is ``m·world``, known to
    the host without a collective. The first time a value of ``m`` is seen
    it is checked, with one collective read on the host: Σm and Σm² over the
    replicas equal ``m·world`` and ``m²·world`` only when every replica has
    ``m`` rows. A capture forbids that read, so a size first met while the
    current stream captures a CUDA graph raises: the eager warm-up step
    before a capture meets every size of the step."""
    if replicas is None:
        return m
    if replicas.mesh is not None and replicas.mesh.spatial > 1:
        try:
            return replicas.spatial_counts[m]
        except KeyError:
            raise RuntimeError(f"sync-BN meets a band of {m} rows per channel that no plane "
                               "of the registered band plan gives this rank") from None
    if m not in replicas._rows_checked:
        if _capturing():
            raise RuntimeError(
                f"sync-BN meets a plane of {m} rows per channel for the first time inside "
                "a CUDA graph capture; its check reads a collective on the host, which a "
                "capture forbids: run the step eagerly once before capturing it")
        t = torch.tensor([float(m), float(m) * m], dtype=torch.float64, device=replicas.device)
        _issue(replicas, "all_reduce (sync-BN rows)", dist.all_reduce, t)
        if t.tolist() != [float(m) * replicas.world, float(m) * m * replicas.world]:
            raise ValueError(f"sync-BN needs the same batch shape on every replica; rank "
                             f"{replicas.rank} has {m} rows per channel, the replicas "
                             f"{t.tolist()[0]:.0f} in all")
        replicas._rows_checked.add(m)
    return m * replicas.world
