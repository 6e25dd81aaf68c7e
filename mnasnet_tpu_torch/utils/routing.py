"""Per-batch routing of the inference callables: eager, a CUDA graph, or
``torch.compile``.

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

The reference's separate "train" option set has no counterpart here: the
train step stays eager (its BN+ReLU backward kernels are not yet
``torch.library`` ops, so neither a graph nor a compile can hold them).
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch
from torch.utils._pytree import tree_map

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
    raw = os.environ.get(_ENV_KEY)
    if raw is not None:
        s = raw.strip().lower()
        if s in _DISABLED:
            return "eager"
        if s not in ROUTES:
            raise ValueError(f"{_ENV_KEY}={raw!r}: expected one of {ROUTES} or none/off")
        return s
    if torch.device(device).type != "cuda":
        return "eager"
    return route_for_batch(batch_size)


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
        x = args[self._batch_arg]
        device = self._device or x.device
        args = tuple(a.to(device) if torch.is_tensor(a) else a for a in args)
        bs = int(args[self._batch_arg].shape[0])
        route = (self._route_for or (lambda b: default_route(b, device)))(bs)
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; choices: {ROUTES}")
        key = (route, tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else a
                            for a in args))
        run = self._cache.get(key)
        if run is None:
            run = self._build(route, key, args, device)
            self._cache[key] = run
        self.calls[key] = self.calls.get(key, 0) + 1
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
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            out = self._fn(*static)
        self.replays[key] = 0

        def replay(*call_args):
            for buf, a in zip(static, call_args):
                buf.copy_(a)
            graph.replay()
            self.replays[key] += 1
            return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, out)

        return replay
