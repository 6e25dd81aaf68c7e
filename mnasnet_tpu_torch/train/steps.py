"""Train, eval and predict steps. Counterpart of ``mnasnet_tpu/train/steps.py``
(``make_train_step`` with its grad-accumulation form,
``make_local_bn_train_step``, ``fused_ema_stats``, ``auto_grad_accum``,
``make_eval_step``, ``make_predict_fn``).

A PyTorch module owns its parameters and BN statistics and the optimizer its
state, so the returned functions take the images (and labels) only, plus the
:class:`~mnasnet_tpu_torch.train.state.TrainState` for training. Images are
NHWC, as the JAX package takes them (a batch of ``eval_transform`` outputs);
they go to the model's device and into NCHW channels_last without a copy.

Data parallelism: with a :class:`~mnasnet_tpu_torch.parallel.Replicas`
handle each process passes its shard of the global batch, the same shape on
every replica, and holds a full replica of the state. The reference writes
its step as global-batch math and lets GSPMD shard it (``steps.py:1-8``);
here the step makes the collectives itself, and every replica makes the same
update. The dropout mask of a step is drawn once for the whole global batch
(from the generator every replica holds in the same state) and each shard,
and each microbatch, takes its rows.

Under a ``dcn × data × spatial`` mesh (``parallel/mesh.py``) a shard is a
data shard, held by the ``spatial`` ranks of a spatial group, each with
its band of the images' rows; the pooled features and so the logits, the
loss and the dropout rows are the whole images' on each of them. Each
rank weights its loss by its shard's valid labels over the world's count,
which counts every sample ``spatial`` times: so each rank's loss is
1/spatial of its shard's share, and the pooled sums' all-reduce, whose
backward sums the group's gradients, gives each band the whole shard's
gradient. The world-wide sum of the gradients then counts every band of
every shard once, the one-process gradient. The loss sums the same way;
the top-k counts enter the sums from the first rank of each group alone.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mnasnet_tpu_torch.models.layers import BatchNorm, replicas_of
from mnasnet_tpu_torch.ops.depthwise import resolve_impl
from mnasnet_tpu_torch.parallel.dist import Replicas, all_reduce_max_, all_reduce_sum_
from mnasnet_tpu_torch.parallel.mesh import counts_once, data_layout, spatial_of
from mnasnet_tpu_torch.train.loss import cross_entropy, topk_correct
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.utils.routing import TrainRouted, default_train_route

# The reference's microbatch limit: on its TPU the bs128->bs256 train step
# lost ~14% to a conv-tiling cliff, so ``auto_grad_accum`` keeps per-chip
# microbatches at or below 128 (``mnasnet_tpu/train/steps.py:22-29``).
MICROBATCH_LIMIT = 128

# The microbatch limit of ``--grad-accum 0`` on CUDA, or None for the direct
# step. ``python -m mnasnet_tpu_torch.tools.memory_probe`` times the
# production step of mnasnet1_0@224 at B 256 and 512, direct against
# microbatches of MICROBATCH_LIMIT, twice in turns. On an H100 80GB HBM3 at
# 700 W the direct step won both by more than the runs' spread: 61.17 /
# 60.05 against 69.76 / 69.75 ms at 256 (2x128), 110.32 / 110.33 against
# 135.83 / 135.87 ms at 512 (4x128), for 6.96 against 3.63 GB and 13.61
# against 3.80 GB of peak memory (H100_MEMORY_PROBE_pr12.json, PERF.md). So
# the H100 has no cliff at 128, and auto is the direct step.
CUDA_MICROBATCH_LIMIT: int | None = None


def auto_grad_accum(per_chip_batch: int, limit: int = MICROBATCH_LIMIT) -> int:
    """Accumulation factor for ``--grad-accum auto`` (``steps.py:32``): the
    smallest K that divides ``per_chip_batch`` and brings the microbatch to
    at most ``limit``; 1 when the batch fits, or when no divisor exists
    without splitting below ``limit / 2``."""
    if per_chip_batch <= limit:
        return 1
    k0 = -(-per_chip_batch // limit)
    for k in range(k0, 2 * k0 + 1):
        if per_chip_batch % k == 0:
            return k
    return 1


def resolve_auto_grad_accum(batch_size: int, batch_shards: int, backend: str, *,
                            sync_bn: bool, fused_updates: bool,
                            limit: int | None = CUDA_MICROBATCH_LIMIT) -> int:
    """``--grad-accum 0`` (auto), as the reference's ``train.py:262-280``
    resolves it on its TPU: :func:`auto_grad_accum` of the per-process batch
    at ``limit``, on CUDA only, and only with sync-BN and fused updates (the
    prerequisites of accumulation) and a global batch that divides over the
    ``batch_shards`` processes; else the direct step, 1. ``limit`` None (the
    measured H100 rule, :data:`CUDA_MICROBATCH_LIMIT`) is always 1."""
    if (backend == "cuda" and limit is not None and sync_bn and fused_updates
            and batch_size % batch_shards == 0):
        return auto_grad_accum(batch_size // batch_shards, limit)
    return 1


def fused_ema_stats(old: torch.Tensor, batch: torch.Tensor, decay: float) -> torch.Tensor:
    """``decay·old + (1−decay)·batch`` over the whole flattened BN statistics
    in one pass (``steps.py:52``); the same elementwise math as per layer."""
    return decay * old + (1.0 - decay) * batch


def _stat_buffers(model: nn.Module) -> list[torch.Tensor]:
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    with torch.no_grad():
        torch._foreach_copy_(tensors, [t.view_as(s) for t, s in
                                       zip(flat.split([s.numel() for s in tensors]), tensors)])


def _ema_outside(model: nn.Module) -> float | None:
    """The BN EMA decay when the model leaves the running-stat EMA to the step."""
    return model.bn_momentum if getattr(model, "bn_ema", "module") == "external" else None


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_train_step(model: nn.Module, tx, label_smoothing: float = 0.1,
                    diagnostics: bool = False, grad_accum: int = 1,
                    replicas: Replicas | None = None, route: str | None = None,
                    **compile_kwargs) -> TrainRouted:
    """``train_step(state, images NHWC, labels) -> (state, metrics)``
    (``steps.py:81-250``): the model's train-mode forward, the label-smoothed
    loss, the gradients of every parameter, the BN-statistics EMA when the
    model has ``bn_ema="external"`` (one flat :func:`fused_ema_stats`), and
    one optimizer update; ``state.step`` advances by one. Parameters, BN
    statistics and optimizer state update in place; the model's train/eval
    mode is restored on return. ``tx`` is bound to ``model`` by
    ``TrainState.create``.

    ``route``: how the step runs (``utils/routing.py``, the counterpart of
    the reference's ``jax.jit(step, donate_argnums=(0,))``): ``"eager"``,
    ``"graph"`` (one CUDA graph per input shape) or ``"compile"``
    (``torch.compile`` of the forward and loss, with ``compile_kwargs``);
    None takes :func:`~mnasnet_tpu_torch.utils.routing.
    default_train_route`. Every route computes the same step; the returned
    :class:`~mnasnet_tpu_torch.utils.routing.TrainRouted` counts its
    ``calls`` and graph ``replays``.

    ``grad_accum=k`` splits the batch into k microbatches of consecutive
    rows, takes each one's gradients and BN statistics from the same
    parameters, combines the gradients and the loss weighted by each
    microbatch's share of the valid labels and the statistics by their mean,
    and makes one update: the same step as k replicas with per-replica BN.
    It requires ``bn_ema="external"``. ``diagnostics=True`` adds the grad,
    update and param norms and the largest |logit| to the metrics.

    ``replicas``: sync-BN data parallelism, the step of the global batch
    (the model's BatchNorms must hold the same handle,
    ``models/layers.py:set_replicas``). Each replica weights its loss by its
    share of the global count of valid labels before the backward, so that
    the BN backward's cross-replica sums are those of the global loss even
    when the shards hold different numbers of valid labels, and the
    gradients, the loss and the top-k counts are summed over the replicas in
    one collective. Collectives per step: one for the global count, one for
    the gradients and metrics, a MAX for the largest |logit| under
    ``diagnostics``, and those of the BatchNorms (``models/layers.py``).
    With ``grad_accum=k`` microbatch i is each replica's i-th local
    microbatch, normalised with the moments of all replicas' i-th
    microbatches. The reference reshapes the global batch instead
    (``steps.py:185-188``), so its microbatch i holds other rows; the math
    of each group is the same. With NCCL replicas on the card the default
    route is the graph, as the reference jits its data-parallel step: a
    replay issues the step's kernels and its :func:`step_collectives`
    all-reduces on the device, and the host issues nothing but the replay
    (the host part, ``tx.prepare()``, writes the step scalars before it).
    Gloo replicas run eager (a gloo collective runs on the host); the
    compile route is not taken with replicas
    (``utils/routing.py:check_replicas_route``).
    """
    if replicas_of(model) is not replicas:
        raise ValueError("sync-BN: the model's BatchNorms must hold the step's replica "
                         "handle (models.layers.set_replicas)")
    parts = _StepParts(model, tx, label_smoothing, diagnostics, grad_accum, replicas,
                       local_bn=False)
    return _routed(parts, route, replicas, compile_kwargs)


def make_local_bn_train_step(model: nn.Module, tx, label_smoothing: float = 0.1,
                             replicas: Replicas | None = None, route: str | None = None,
                             **compile_kwargs) -> TrainRouted:
    """The train step with per-replica BN statistics (``--no-sync-bn``,
    ``steps.py:253-342``): each replica normalises with the moments of its
    own shard (the model's BatchNorms hold no handle), and the gradients,
    the loss and the top-k counts are combined weighted by each replica's
    share of the valid labels. The running-statistics EMA takes the
    cross-replica mean of the raw local statistics, so the state stays
    replicated (the reference's choice over stock DDP, which keeps rank 0's).
    Collectives per step: one for the global count, one for the gradients,
    metrics and statistics. The dropout mask is the global batch's, so the
    replicas' masks differ, as the reference's ``fold_in(step_rng,
    axis_index)`` makes them (``steps.py:283``). The step equals the
    single-process ``grad_accum=world`` step on the concatenated shards.
    ``route`` as in :func:`make_train_step`: over NCCL a replay issues the
    two all-reduces with the step's kernels."""
    if replicas_of(model) is not None:
        raise ValueError("local BN: the model's BatchNorms must hold no replica handle")
    mesh = getattr(replicas, "mesh", None)
    if mesh is not None and mesh.spatial != 1:
        raise ValueError("local-BN path requires spatial mesh axis of size 1")
    if mesh is not None and mesh.dcn != 1:
        raise ValueError("local-BN path shards only over 'data'; use sync-BN for multi-slice "
                         "('dcn') meshes")
    parts = _StepParts(model, tx, label_smoothing, False, 1, replicas, local_bn=True)
    return _routed(parts, route, replicas, compile_kwargs)


def _routed(parts, route, replicas, compile_kwargs) -> TrainRouted:
    if route is None:
        route = default_train_route(parts.device, replicas)
    return TrainRouted(parts, route, **compile_kwargs)


class _StepParts:
    """The train step split where the host must act, for
    :class:`~mnasnet_tpu_torch.utils.routing.TrainRouted`:

      * :meth:`inputs`: the checks, and the batch on the model's device;
      * :meth:`host`: ``state.step`` and the optimizer's counts and step
        scalars (``tx.prepare()``), on every call of every route;
      * :meth:`device_step`: the rest, device work only, so that a CUDA graph can
        capture it: the dropout draw, per microbatch :meth:`forward_loss`
        and ``torch.autograd.grad``, the metrics, and :meth:`update` (the
        flat BN EMA, ``tx.apply`` and the parameters' ``_foreach_add_``).
        The compile route compiles ``forward_loss``, which AOTAutograd
        differentiates; the generator and ``torch.autograd.grad`` stay
        outside the compiled region.
    """

    def __init__(self, model, tx, label_smoothing, diagnostics, grad_accum, replicas,
                 local_bn):
        self.ema_decay = _ema_outside(model)
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if grad_accum > 1 and self.ema_decay is None:
            raise ValueError(
                "grad_accum > 1 requires bn_ema='external' on the model: the step "
                "combines per-microbatch BN statistics and applies the running-stats "
                "EMA exactly once per optimizer update")
        self.model, self.tx = model, tx
        self.label_smoothing = label_smoothing
        self.diagnostics, self.grad_accum = diagnostics, grad_accum
        self.replicas, self.local_bn = replicas, local_bn
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.stats = _stat_buffers(model)
        self.device = self.params[0].device
        # The dropout rows of this rank's shard of the global batch.
        self.shard, self.shards = data_layout(replicas)
        self.counts_once = counts_once(replicas)
        # Weights by the share of valid labels: needed to combine microbatches
        # or replicas; the plain step on one process takes the loss as it is.
        self.weighted = grad_accum > 1 or replicas is not None

    def inputs(self, images, labels) -> tuple[torch.Tensor, torch.Tensor]:
        """NHWC images and labels on the model's device."""
        x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
        x = x.to(self.device, non_blocking=True)
        y = torch.as_tensor(labels).to(x.device)
        if x.shape[0] % self.grad_accum:
            raise ValueError(f"batch size {x.shape[0]} not divisible by "
                             f"grad_accum={self.grad_accum}")
        return x, y

    def host(self, state: TrainState) -> None:
        state.step += 1
        self.tx.prepare()

    def forward_loss(self, x, y, keep, total):
        """The microbatch's loss (weighted by its share of ``total`` valid
        labels when given) and its logits; x NCHW."""
        logits = self.model(x, keep=keep)
        loss = cross_entropy(logits, y, self.label_smoothing)
        if total is not None:
            loss = loss * ((y >= 0).sum().float() / total)
        return loss, logits

    def update(self, grads, old, new):
        """The BN EMA, the optimizer's update and ``p + u``; the updates."""
        with torch.no_grad():
            if self.ema_decay is not None:
                _unflat_(fused_ema_stats(old, new, self.ema_decay), self.stats)
            updates = self.tx.apply(dict(zip(self.names, grads)))
            ups = [updates[n] for n in self.names]
            torch._foreach_add_(self.params, ups)
        return ups

    def device_step(self, images, labels, generator, forward_loss=None) -> dict:
        """The device part of one step on NHWC ``images``; the metrics."""
        forward_loss = forward_loss or self.forward_loss
        model, replicas, stats = self.model, self.replicas, self.stats
        k, shards, shard = self.grad_accum, self.shards, self.shard
        was_training = model.training
        model.train()
        try:
            x = images.permute(0, 3, 1, 2)
            y = labels
            n = x.shape[0]
            micro = n // k
            keep = model.dropout_keep(n * shards, generator, x.device)
            if keep is not None:
                keep = keep[shard * n:(shard + 1) * n]
            total = None
            if self.weighted:
                total = (y >= 0).sum().float()
                all_reduce_sum_([total], replicas, "all_reduce (label count)")
                total = total.clamp(min=1)
            old = _flat(stats) if self.ema_decay is not None else None
            grads = loss = counts = new = None
            maxl = torch.zeros((), device=x.device)
            for i in range(k):
                rows = slice(i * micro, (i + 1) * micro)
                yi = y[rows]
                li, logits = forward_loss(x[rows], yi, None if keep is None else keep[rows],
                                          total)
                gi = torch.autograd.grad(li, self.params)
                li, logits = li.detach(), logits.detach()
                ci = topk_correct(logits, yi)
                if not self.counts_once:
                    ci = {key: v * 0 for key, v in ci.items()}
                if self.diagnostics:
                    maxl = torch.maximum(maxl, logits.abs().max())
                si = _flat(stats) if self.ema_decay is not None else None
                if i == 0:
                    grads, loss, counts, new = list(gi), li, ci, si
                else:
                    torch._foreach_add_(grads, gi)
                    loss = loss + li
                    counts = {key: counts[key] + ci[key] for key in ci}
                    new = new + si
            if k > 1:
                new = new / k
            metrics = {"loss": loss, **counts}
            if replicas is not None:
                # One collective: the gradients, the metrics and, under local
                # BN, the statistics, whose mean over the replicas is kept:
                # the raw ones before the external EMA, or those after the
                # module's EMA (the EMA is linear, so both are the EMA of the
                # mean).
                local_bn = self.local_bn
                shared = ((new if self.ema_decay is not None else _flat(stats))
                          if local_bn else None)
                all_reduce_sum_([*grads, *metrics.values(),
                                 *([shared] if local_bn else [])], replicas,
                                "all_reduce (gradients)")
                if local_bn:
                    shared = shared / shards
                    if self.ema_decay is not None:
                        new = shared
                    else:
                        _unflat_(shared, stats)
                if self.diagnostics:
                    all_reduce_max_(maxl, replicas, "all_reduce (max logit)")
            ups = self.update(grads, old, new)
            if self.diagnostics:
                with torch.no_grad():  # no autograd record of the norms
                    metrics["grad_norm"] = _global_norm(grads)
                    metrics["update_norm"] = _global_norm(ups)
                    metrics["param_norm"] = _global_norm(self.params)
                metrics["max_abs_logit"] = maxl
        finally:
            model.train(was_training)
        return metrics


def step_collectives(model: nn.Module, sync_bn: bool = True, diagnostics: bool = False,
                     grad_accum: int = 1, image_rows: int | None = None) -> int:
    """The collectives one data-parallel train step issues, as the code is
    written: the global count and the one flat buffer (and a MAX under
    ``diagnostics``), and under sync-BN per microbatch and per BatchNorm the
    moments' (one for ``one_pass``, two for ``two_pass``); in the backward a
    BatchNorm of a BN+ReLU region on the kernel route sums its (2, C) once,
    any other sums the moments' gradients as often as its forward summed the
    moments. A BatchNorm is in a region when a ReLU follows it in its
    Sequential. The first step also checks each new plane size once
    (``parallel.global_rows``). ``remat`` adds none: a block's recompute
    replays the sums of its forward (``parallel/dist.py:taped_sums``).

    Under a spatial mesh (the model's BatchNorms hold replicas with one) the
    step of ``image_rows``-row images also issues, per microbatch, the halo
    exchanges and the pooled sums of ``MNASNet.spatial_collectives``.

    On the graph route this is what one replay issues on the device, NCCL
    kernels all; the counters see them at the warm-up step and the capture
    of a shape's first call (twice that call), and at no replay."""
    n = 2 + int(diagnostics)
    if not sync_bn:
        return n
    mesh = spatial_of(replicas_of(model))
    if mesh is not None:
        if image_rows is None:
            raise ValueError("the collectives of a step under a spatial mesh depend on the "
                             "image rows: pass image_rows")
        n += grad_accum * model.spatial_collectives(image_rows, mesh.spatial)
    kernel_route = resolve_impl(model.bn_bwd, next(model.parameters())) == "kernel"
    per_microbatch = 0
    for seq in model.modules():
        if not isinstance(seq, nn.Sequential):
            continue
        for i, bn in enumerate(seq):
            if isinstance(bn, BatchNorm):
                fwd = 1 if bn.stats == "one_pass" else 2
                region = kernel_route and i + 1 < len(seq) and isinstance(seq[i + 1], nn.ReLU)
                per_microbatch += fwd + (1 if region else fwd)
    return n + grad_accum * per_microbatch


def _images(model: torch.nn.Module, images) -> torch.Tensor:
    dev = next(model.parameters()).device
    x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
    return x.to(dev, non_blocking=True).permute(0, 3, 1, 2)


def make_eval_step(model: torch.nn.Module, label_smoothing: float = 0.0):
    """eval_step(images, labels) -> metrics (running-stats BN, no dropout).

    It runs under ``no_grad``, not ``inference_mode``: Dynamo cannot compile
    a function that enters inference mode, and the eval and predict steps
    are served through the compile route too (``utils/routing.py``)."""

    @torch.no_grad()
    def eval_step(images, labels):
        logits = model(_images(model, images))
        labels = torch.as_tensor(labels).to(logits.device)
        return {
            "loss": cross_entropy(logits, labels, label_smoothing),
            **topk_correct(logits, labels),
        }

    return eval_step


def make_predict_fn(model: torch.nn.Module):
    """predict(images NHWC) -> fp32 logits: the single-image request path and
    the serving path. ``no_grad`` as in :func:`make_eval_step`."""

    @torch.no_grad()
    def predict(images):
        return model(_images(model, images))

    return predict
