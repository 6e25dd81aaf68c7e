"""Routing of the inference callables (per batch size) and of the train step:
eager, a CUDA graph, or ``torch.compile``.

Counterpart of ``mnasnet_tpu/utils/xla_options.py``. The reference jits every
eval and predict step and chooses, per batch size, the XLA compile options
measured best for it on its TPU (``INFER_OPTIONS_BATCH_RANGES``,
``BatchRoutedJit``). The port runs eagerly, and what a batch size costs on an
H100 is mostly the host's time to issue the forward's ~410 launches
(``PERF.md`` §5). So the port's choice per batch size is between three ways
to run the same forward:

  * ``"eager"``: the callable as it is, every launch issued from Python;
  * ``"graph"``: one ``torch.cuda.CUDAGraph`` per input shape, captured
    after a warm-up, then replayed: one launch from the host per call;
  * ``"compile"``: one ``torch.compile(fn, dynamic=False)`` per input shape
    (Inductor: fused elementwise work, the port's kernels called as opaque
    ops).

:data:`SERVE_ROUTE_BATCH_RANGES` holds the route measured fastest at each
batch size on the card; :func:`default_route` looks it up for CUDA and
returns ``"eager"`` off the card, as the reference returns no options off
its TPU. :class:`BatchRouted` resolves the route per call from the batch
argument's leading dimension and keeps one callable per (route, input
shapes). A capture or a compile that fails raises; nothing drops back to
eager, and a compile past Dynamo's recompile limit raises too.

The train step has one route, :data:`TRAIN_ROUTE`, as the reference has one
"train" option set for its one jitted step with donated state
(``mnasnet_tpu/train/trainer.py:122-128``): :func:`default_train_route`
returns it on the card and eager elsewhere, and :class:`TrainRouted` runs
the step on it. The kernels' launches from ``ctypes`` are captured by a
graph like any other launch; what a graph must not freeze is what the host
decides every step (``state.step``, the optimizer's count and its step
scalars, ``train/optim.py``), so the step is split there
(``train/steps.py:_StepParts``), and the dropout generator is registered
with the graph. ``torch.compile`` needs every kernel as a ``torch.library``
op (the BN+ReLU backward's too, ``ops/cuda/bn_bwd.py``).

With data-parallel replicas over NCCL the graph route is taken too, as the
reference jits its data-parallel step over the mesh: the graph holds the
whole sync-BN (or local-BN) step with its collectives, and a replay issues
on the device, in the step's order, the step's kernels and its
``train/steps.py:step_collectives`` NCCL all-reduces (the BN moments, the
(2, C) sums of each BN+ReLU region's backward between its two kernels,
the global count and the one flat buffer of the gradients and metrics),
each on NCCL's stream joined to the graph's by events. A gloo collective
runs on the host and cannot be captured, so gloo replicas run eager; the
compile route is not taken with replicas.
"""

from __future__ import annotations

import contextlib
import gc
import os
import types

import numpy as np
import torch
from torch.utils._pytree import tree_map

from mnasnet_tpu_torch.utils.profiling import span

ROUTES = ("eager", "graph", "compile")

# The fastest route by batch size of the serving artifact of mnasnet1_0@224,
# bf16, on an NVIDIA H100 80GB HBM3 at 700 W: ``python3 chip_smoke.py --only
# serve`` timed eager and graph at bs 1, 8, 32, 128 and compile at bs 1 and
# 128 (PERF.md §6, PR 7). Each measured size rules from itself up to the
# next one; (lo, hi, route), hi inclusive. The graph won at every size, by
# 4.1-8.4x over eager and 2.2-3.9x over compile (ms per batch, eager /
# graph / compile: bs1 13.75 / 1.64 / 6.42, bs8 11.20 / 1.93, bs32
# 10.99 / 2.25, bs128 15.34 / 3.78 / 8.32).
SERVE_ROUTE_BATCH_RANGES: tuple[tuple[int, int, str], ...] = (
    (1, 1 << 30, "graph"),
)

# The fastest train route of mnasnet1_0@224, bs128, bf16, on the production
# configuration (external BN EMA, s2d stem, RMSProp fused="small"), on an
# NVIDIA H100 80GB HBM3 at 700 W: ``python3 chip_smoke.py`` timed the three
# routes in one call (PERF.md §6): ms per step eager 108.11, graph 36.77
# (the card 95.5% busy), compile 65.77 (host-bound).
TRAIN_ROUTE = "graph"

# Warm-up calls of the graph route before its capture: they run eagerly,
# on a side stream, so that every lazy set-up (libraries, plans, kernels
# built and loaded) happens before the capture.
GRAPH_WARMUP = 1

_ENV_KEY = "MNASNET_TPU_TORCH_ROUTE"
_DISABLED = ("", "none", "off", "0")


def route_for_batch(batch_size: int) -> str:
    """The route :data:`SERVE_ROUTE_BATCH_RANGES` gives ``batch_size``."""
    for lo, hi, route in SERVE_ROUTE_BATCH_RANGES:
        if lo <= batch_size <= hi:
            return route
    raise ValueError(f"no route for batch size {batch_size}")


def default_route(batch_size: int, device="cuda") -> str:
    """The route of a batch of ``batch_size`` run on ``device``.

    Resolution order: the ``MNASNET_TPU_TORCH_ROUTE`` environment variable
    (``none``/``off``/``0``/empty: eager; a route name: that route for every
    batch size and device) -> the measured table on a CUDA device -> eager
    elsewhere.
    """
    route = _env_route()
    if route is not None:
        return route
    if torch.device(device).type != "cuda":
        return "eager"
    return route_for_batch(batch_size)


def _env_route() -> str | None:
    raw = os.environ.get(_ENV_KEY)
    if raw is None:
        return None
    s = raw.strip().lower()
    if s in _DISABLED:
        return "eager"
    if s not in ROUTES:
        raise ValueError(f"{_ENV_KEY}={raw!r}: expected one of {ROUTES} or none/off")
    return s


def default_train_route(device="cuda", replicas=None) -> str:
    """The route of the train step on ``device``.

    Resolution order: the ``MNASNET_TPU_TORCH_ROUTE`` environment variable
    (as :func:`default_route` reads it) -> :data:`TRAIN_ROUTE` on a CUDA
    device -> eager elsewhere. With ``replicas`` (data parallelism) and
    no variable, NCCL replicas on the card take :data:`TRAIN_ROUTE` and
    gloo replicas, whose collectives run on the host, run eager; a route
    the replicas cannot take (asked for by the variable) raises when the
    step is built (:func:`check_replicas_route`, in :class:`TrainRouted`)."""
    route = _env_route()
    if route is None:
        on_card = torch.device(device).type == "cuda"
        route = TRAIN_ROUTE if on_card and (
            replicas is None or replicas.backend == "nccl") else "eager"
    return route


def check_replicas_route(route: str, replicas) -> None:
    """Raise unless the train step of ``replicas`` can run on ``route``: the
    graph route captures the collectives, which NCCL runs on the device and
    gloo on the host; the compile route is not taken with replicas."""
    if route == "compile":
        raise ValueError(f"the 'compile' train route is not taken with replicas (set "
                         f"{_ENV_KEY}=graph or eager, or pass route='graph' or 'eager')")
    if route == "graph" and replicas.backend != "nccl":
        raise ValueError(f"the 'graph' train route is not taken with {replicas.backend} "
                         f"replicas: a {replicas.backend} collective runs on the host and "
                         "cannot be captured into a CUDA graph (NCCL's can)")


@contextlib.contextmanager
def _collector_off():
    """No automatic garbage collection inside. A collection during a capture
    may free a dead reference cycle that holds a CUDA graph (a routed
    callable dropped earlier), and destroying a graph while a stream
    captures is an error that loses the capture; this PyTorch no longer
    collects before a capture. The cycle goes at the next collection."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _fresh_function(fn):
    """A trampoline calling ``fn`` whose code object is its own: Dynamo keeps
    its compiled frames on the code object, so separate ``torch.compile``
    objects of one function share one cache and one recompile limit. A code
    object per batch size gives each its own."""
    def call(*args):
        return fn(*args)

    return types.FunctionType(call.__code__.replace(), call.__globals__, call.__name__,
                              None, call.__closure__)


class BatchRouted:
    """``fn(*args)`` run on the route its batch size is given.

    ``args[batch_arg]``'s leading dimension is the batch size; ``route_for``
    maps it to a route (default :func:`default_route` on ``device``; tests
    inject a recording one). ``device`` is where ``fn`` runs (default: the
    batch argument's device); numpy arrays become tensors and tensor
    arguments are moved there. One callable
    is kept per (route, shapes and dtypes of the arguments):

      * graph: static input buffers, ``GRAPH_WARMUP`` eager calls on a side
        stream, one capture into a memory pool that all captures of this
        object share; a call copies its arguments in, replays, and returns a
        copy of the static output, so that the next replay does not
        overwrite a result the caller holds;
      * compile: ``torch.compile(fn, dynamic=False, fullgraph=True,
        **compile_kwargs)`` on a code object of its own, with Dynamo told to
        fail, not fall back, at its recompile limit.

    ``calls`` counts the calls per key and ``replays`` the graph replays per
    key: a kernel's launch counter advances when its wrapper runs (eager
    calls, warm-ups, captures, compiled calls), not when a graph replays.
    While a profiler runs, a call is the span ``mnasnet.route.call`` (its
    route, batch size and index among its key's calls) holding ``copy_in``
    (the arguments to the device, with the host's wait for a blocking copy),
    ``build`` at a key's first call, then ``replay`` and ``copy_out`` (graph)
    or ``run`` (eager, compile): :func:`~mnasnet_tpu_torch.utils.profiling.span`.
    """

    def __init__(self, fn, *, batch_arg: int = 0, route_for=None, device=None,
                 **compile_kwargs):
        self._fn = fn
        self._batch_arg = batch_arg
        self._route_for = route_for
        self._device = None if device is None else torch.device(device)
        self._compile_kwargs = {"fullgraph": True, **compile_kwargs}
        self._cache: dict = {}
        self._pool = None
        self.calls: dict = {}
        self.replays: dict = {}

    def __call__(self, *args):
        args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
        device = self._device or args[self._batch_arg].device
        bs = int(args[self._batch_arg].shape[0])
        route = (self._route_for or (lambda b: default_route(b, device)))(bs)
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; choices: {ROUTES}")
        key = (route, tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else a
                            for a in args))
        n = self.calls.get(key, 0)
        with span("mnasnet.route.call", lambda: f"route={route} batch={bs} call={n}"):
            with span("mnasnet.route.copy_in"):
                args = tuple(a.to(device) if torch.is_tensor(a) else a for a in args)
            run = self._cache.get(key)
            if run is None:
                with span("mnasnet.route.build"):
                    run = self._build(route, key, args, device)
                self._cache[key] = run
            self.calls[key] = n + 1
            if route == "graph":
                return run(*args)  # its replay and its copy out are spans of their own
            with span("mnasnet.route.run"):
                return run(*args)

    def _build(self, route: str, key, args, device):
        if route == "eager":
            return self._fn
        if route == "compile":
            torch._dynamo.config.fail_on_recompile_limit_hit = True
            return torch.compile(_fresh_function(self._fn), dynamic=False,
                                 **self._compile_kwargs)
        return self._capture(key, args, device)

    def _capture(self, key, args, device):
        if device.type != "cuda":
            raise ValueError(f"the graph route runs on a CUDA device, not {device}")
        if not all(torch.is_tensor(a) for a in args):
            raise TypeError("the graph route takes tensor arguments only")
        static = [a.clone() for a in args]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                self._fn(*static)
        torch.cuda.current_stream(device).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # thread_local: a loader thread may pin and copy the next batch
        # meanwhile, on its own stream, which the capture does not hold.
        with _collector_off(), torch.cuda.graph(graph, pool=self._pool,
                                                capture_error_mode="thread_local"):
            out = self._fn(*static)
        self.replays[key] = 0

        def replay(*call_args):
            with span("mnasnet.route.replay"):
                for buf, a in zip(static, call_args):
                    buf.copy_(a)
                graph.replay()
                self.replays[key] += 1
            with span("mnasnet.route.copy_out"):
                return _clone(out)

        return replay


def _clone(tree):
    return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, tree)


class TrainRouted:
    """The train step ``(state, images, labels) -> (state, metrics)`` on one
    route; ``steps`` is the step split by ``train/steps.py:_StepParts``.

    Every call checks the batch, then runs the host part (``state.step``,
    the optimizer's counts and step scalars) and then the device part:

      * eager: the device part as it is;
      * graph: one ``torch.cuda.CUDAGraph`` per input shape, in a memory pool
        of this object's own (apart from the eval graphs'). The first call of
        a shape runs its step eagerly on a side stream (the warm-up is that
        call's step, the one the eager route would take) and then captures
        the device part with the dropout generator registered with the
        graph: the capture runs no kernel and moves no count, nor the
        generator (checked). A later call copies the batch into the graph's
        static inputs, replays, and returns a copy of the metrics, so that
        the next replay does not overwrite them. Each replay draws the next
        dropout mask from the generator's current state, so that a
        ``set_state`` carries into the replays;
      * compile: ``torch.compile(dynamic=False, fullgraph=True,
        **compile_kwargs)`` of the forward and loss (AOTAutograd
        differentiates it; the kernels are opaque ops in both graphs), one
        per input shape on a code object of its own, with Dynamo told to
        fail at its recompile limit; the dropout draw,
        ``torch.autograd.grad`` and the update run eagerly around it. (A
        compiled update, its ``_foreach`` chains over every parameter, made
        the cold compile of mnasnet1_0@224 take 464 s on the card.)

    ``calls`` counts the calls per key and ``replays`` the graph replays: a
    kernel's launch counter, and ``Replicas.collectives``, advance at eager
    and compiled calls and at a graph's first call (its warm-up and its
    capture), not at a replay (:meth:`counted`). While a profiler runs, a
    call is the span ``mnasnet.train.step`` (route, batch, ``state.step``
    before it) holding ``copy_in`` (``_StepParts.inputs``), ``host``
    (``_StepParts.host``), then ``build`` at a shape's first call, else
    ``replay`` and ``copy_out`` (graph) or ``run`` (eager, compile).
    Parameters, buffers and optimizer state are written in place by every
    path that changes them (checkpoint restore, BN recalibration,
    ``swapped_params``), so a captured graph stays valid across them.

    Replicas over NCCL (``steps.replicas``): the warm-up step makes every
    host-side first: NCCL's communicator (created at the group's first
    collective), each BN plane size's check (``parallel.global_rows``,
    which raises if the capture meets a new one), the kernels' plans.
    Every replica takes the same input shape, so every replica captures at
    the same call; a replay issues the step's collectives with its kernels.
    Each graph is registered with the replicas (``Replicas.add_graph``),
    so that ``parallel.close`` resets it before it leaves the group.
    A replay's collectives reach no watchdog, so each replay puts an event
    behind it for the replicas' host deadline (``Replicas.watch``), which
    ends the process if a dead peer keeps it from completing.
    ``capture_error_mode="thread_local"`` leaves other threads free to
    call the CUDA runtime while this one captures: the loader's thread,
    the process group's watchdog and the host deadline's thread, which
    poll the events of collectives issued eagerly.
    """

    def __init__(self, steps, route: str, **compile_kwargs):
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; choices: {ROUTES}")
        self._replicas = getattr(steps, "replicas", None)
        if self._replicas is not None:
            check_replicas_route(route, self._replicas)
        if route == "graph" and steps.device.type != "cuda":
            raise ValueError(f"the graph route runs on a CUDA device, not {steps.device}")
        self.route = route
        self._steps = steps
        self._compile_kwargs = {"fullgraph": True, **compile_kwargs}
        self._cache: dict = {}
        self._pool = None
        self.calls: dict = {}
        self.replays: dict = {}

    def counted(self) -> int:
        """The steps whose launches the kernels' counters saw: every eager
        and compiled call, and for each graph the warm-up and the capture
        of its first call."""
        return sum(n if key[0] != "graph" else n - self.replays[key] + 1
                   for key, n in self.calls.items())

    def __call__(self, state, images, labels):
        with span("mnasnet.train.step",
                  lambda: f"route={self.route} batch={len(images)} step={state.step}"):
            with span("mnasnet.train.copy_in"):
                x, y = self._steps.inputs(images, labels)
            key = (self.route, (tuple(x.shape), x.dtype), (tuple(y.shape), y.dtype))
            run = self._cache.get(key)
            with span("mnasnet.train.host"):
                self._steps.host(state)
            if run is None:
                with span("mnasnet.train.build"):
                    run, metrics = self._build(key, x, y, state.generator)
                self._cache[key] = run
            elif self.route == "graph":
                metrics = run(x, y, state.generator)  # spans its replay and its copy out
            else:
                with span("mnasnet.train.run"):
                    metrics = run(x, y, state.generator)
            self.calls[key] = self.calls.get(key, 0) + 1
            return state, metrics

    def _build(self, key, x, y, generator):
        steps = self._steps
        if self.route == "eager":
            run = steps.device_step
        elif self.route == "compile":
            torch._dynamo.config.fail_on_recompile_limit_hit = True
            fwd = torch.compile(_fresh_function(steps.forward_loss), dynamic=False,
                                **self._compile_kwargs)

            def run(images, labels, gen):
                return steps.device_step(images, labels, gen, fwd)
        else:
            return self._capture(key, x, y, generator)
        return run, run(x, y, generator)

    def _capture(self, key, x, y, generator):
        steps = self._steps
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"the graph route runs on a CUDA device, not {dev}")
        static = (x.clone(), y.clone())
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = steps.device_step(*static, generator)  # this call's step
        current.wait_stream(side)
        for t in metrics.values():
            t.record_stream(current)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if self._replicas is not None:
            self._replicas.add_graph(graph)
        graph.register_generator_state(generator)
        before = generator.get_state()
        # thread_local: a loader thread may pin and copy the next batch
        # meanwhile, on its own stream, which the capture does not hold, and
        # the watchdog and the host deadline poll eager collectives' events.
        with _collector_off(), torch.cuda.graph(graph, pool=self._pool,
                                                capture_error_mode="thread_local"):
            out = steps.device_step(*static, generator)
        if not torch.equal(generator.get_state(), before):
            raise RuntimeError("the capture of the train step moved the dropout generator")
        self.replays[key] = 0

        def replay(images, labels, gen):
            if gen is not generator:
                raise ValueError("the graph route's step was captured with another "
                                 "TrainState's dropout generator")
            with span("mnasnet.train.replay"):
                static[0].copy_(images)
                static[1].copy_(labels)
                graph.replay()
                if self._replicas is not None:
                    # The replayed collectives reach no watchdog; the host's
                    # deadline holds this event to the group's timeout.
                    self._replicas.watch("the replayed train step")
                self.replays[key] += 1
            with span("mnasnet.train.copy_out"):
                return _clone(out)

        return replay, metrics
