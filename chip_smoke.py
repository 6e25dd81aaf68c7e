#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mnasnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # full run: checks and timings
    python3 chip_smoke.py --no-timing  # checks only, for a first run of new kernels
    python3 chip_smoke.py --profile DIR  # also per-kernel device time tables in DIR
    python3 chip_smoke.py --only train   # the train phases only (a new kernel's first run)
    python3 chip_smoke.py --only kernels # the dw and mbconv phases only
    python3 chip_smoke.py --only trainer # the training harness phase only
    python3 chip_smoke.py --only dist    # the data-parallel phase only
    python3 chip_smoke.py --only serve   # the serving deployment phase only
    python3 chip_smoke.py --only knobs   # the model knobs phase only
    python3 chip_smoke.py --only deadrank  # the dead-rank phase only
    python3 chip_smoke.py --only tools   # the measurement tools phase only
    python3 chip_smoke.py --only smoke   # the train smoke's long-run path only
    python3 chip_smoke.py --only spatial # the data x spatial mesh phase only
    python3 chip_smoke.py --only b4      # the efficientnet_b4 phase only

Phases, in order; any failure raises and exits non-zero:
  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles ``mnasnet_tpu_torch/csrc/*.cu`` with nvcc (all at once);
  3. dw: the fused depthwise kernel against its plain version at the 12
     depthwise shapes of mnasnet1_0@224, batch 128, bf16 and fp32; timed,
     also in the form one training step runs it (17 launches, unit affine,
     no ReLU), beside cuDNN's grouped convolution;
  4. mbconv: the fused MBConv kernel against its plain version at the 16
     block shapes of mnasnet1_0@224, batch 128, bf16 and fp32;
  5. serving: ``create_model("mnasnet1_0", dtype=bf16)`` with seeded weights
     and calibrated BN statistics, driven through ``make_predict_fn`` on
     batches of 128x224x224x3; counts the kernel launches of those forwards,
     holds the logits against the "torch" route and an fp32 reference,
     answers one single-image request, and times images/s at batch 128 and
     the latency of a batch of one;
  5b. serve: the serving deployment (``tools/export_latency.py``'s
     counterpart) with the serving phase's weights: (a) ``export_serving``'s
     ``build_forward`` and ``export_artifact`` with ``dw_impl="kernel"`` and a
     symbolic batch (and a fixed batch of 8); a fresh interpreter that
     imports only ``mnasnet_tpu_torch.serving`` loads the artifact, serves
     the bs128 batch on the eager route three times (exactly 1 dw and 16
     MBConv launches a call; logits bit for bit the live
     ``make_predict_fn``'s) and sees the fixed-batch artifact refuse a batch
     of 3; (b) ``load_serving`` on each route at bs 1, 8, 32 and 128: the
     graph route bit for bit eager, the compile route (bs 1 and 128 only)
     within the bf16 bars below against the torch route; ms per batch and
     images/s by route (CUDA events) and the table of the fastest route
     that ``SERVE_ROUTE_BATCH_RANGES`` is set from; every route's launches
     reconciled with its calls (eager and compiled calls count, a graph
     counts its warm-up and capture, not its replays); (c) the seconds of
     the first compiled call at bs1 in two fresh processes with the same
     ``--compilation-cache`` directory, cold then warm (the background job
     ``serve_cache``, on an artifact of its own from the same weights);
  6. bn: the two BN+ReLU backward kernels against their plain versions at the
     35 BN+ReLU regions of the mnasnet1_0@224 training forward, batch 128,
     bf16 and fp32; the bf16 and fp32 ReLU masks exactly (with dy = 1, dβ
     must equal the count of positive forward outputs per channel); two
     launches bit-identical; and times, beside each kernel's bound, its plain
     version, one library call (``native_batch_norm_backward`` on the masked
     g) and the torch route's autograd of the region; each kernel's and
     library call's device time from CUDA-graph replays of one call
     ("device_ms"), and each wrapper's host time per call. The region's two
     forward kernels at the same shapes: the stats kernel's sums against the
     plain version's, the one- and two-pass moments from them against
     float64 within the plain fp32 path's own error, the apply kernel's y bit
     for bit the plain forward's and its y > 0 the backward's mask, two
     launches bit-identical; timed as the backward's, beside their bounds,
     their plain versions and the region's whole plain forward (``_fwd_math``);
  7. dw training op: the depthwise autograd Function's gradients against the
     torch route's at one stride-1 and one stride-2 shape, bf16 and fp32;
  7b. b4: efficientnet_b4's kernels at its own shapes (380 px, batch 64,
     bf16 and fp32): the SiLU apply, reduce and dx at each distinct shape of
     its 64 BN+SiLU regions against their plain versions
     (``bn_relu_apply_reference``, ``bn_bwd_reduce_reference`` and
     ``bn_bwd_dx_reference`` with ``act="silu"``) at the ReLU kernels' bars
     (the apply within one rounding of its dtype), each op's launches counted
     under SiLU and none under ReLU, two launches bit-identical, and the
     ReLU versions failing each bar; the dw kernel's SiLU epilogue at each
     distinct shape of its 32 dw convs against its plain version at the dw
     bars, the ReLU and linear epilogues failing them; timed (bf16) beside
     their bounds and summed over one step's regions and convs; then one
     counted train step (5 steps on the default train route, the counters
     zeroed just before): exactly 64 bn_fwd_stats, 64 each of the SiLU
     apply, reduce and dx, 0 of their ReLU kernels, 32 dw and 0 MBConv
     launches per counted step, and finite losses;
  8. train: ``make_train_step`` on the production configuration
     (``create_model("mnasnet1_0", dtype=bf16, bn_ema="external",
     stem_s2d=True)``, ``create_optimizer("rmsprop", 0.01, fused="small")``,
     label smoothing 0.1) on the default train route (``TRAIN_ROUTE``) for 5
     steps on one fixed batch of 128x224x224x3 with seeded labels: the
     losses finite and falling from step 1 to step 5, and exactly 17 dw, 35
     bn_bwd_reduce, 35 bn_bwd_dx, 35 bn_fwd_stats, 35 bn_relu_apply and 0
     MBConv launches per step the counters see (``TrainRouted.counted``:
     eager and compiled calls, and a graph's warm-up and capture, not its
     replays); under deterministic algorithms,
     with dropout, a warmup-cosine rate that changes every step and the
     model EMA, 5 steps on the graph route and 5 steps eager, eager, graph,
     graph, eager on one state, each bit for bit the all-eager run; one
     fp32 step on the kernel route against the torch route, and the first
     bf16 step of the compile route (Inductor) against the eager one, from
     the same weights, with the seconds of its compile (the background job
     ``train_compile``, beside the others); per train route (eager, graph,
     compile on the kernel route; the torch route eager) in bf16 the ms per
     step, images/s, peak memory and the first call's seconds, and the
     fastest route, which ``TRAIN_ROUTE`` is set from (the compile route
     timed in its job once every other job is done and this process waits);
     with ``--profile``, each eager or graph route's device time and busy
     share and one kernel per counted launch;
  8b. knobs: the model knobs on the same production configuration (bs128,
     bf16; a full run takes it right after train). ``remat``: 3 steps with
     dropout, a changing rate and the model EMA, under deterministic
     algorithms, on the graph route with ``remat`` (this phase's main path:
     exactly 33 dw, 35 bn_bwd_reduce, 35 bn_bwd_dx, 67 bn_fwd_stats, 67
     bn_relu_apply and 0 MBConv launches per counted step, 16 dw and 32 of
     each BN forward kernel's launches the blocks' recomputes), bit for
     bit the eager ``remat`` steps, which are bit for bit the steps without
     ``remat`` (losses, parameters, BN buffers with ``num_batches_tracked``,
     optimizer state, generator); the first step of the compile route with
     ``remat`` against its eager step (the background job
     ``remat_compile``). The first eager step of ``taps``,
     ``taps2`` and ``hybrid`` against the production step, and of
     ``channel_pad`` 64 and 128 on the kernel route against their torch
     route, with the padded models' serving launches (the MBConv blocks the
     planner still admits); the knobs' tests of ``tests/test_torch_gpu.py``
     in a child pytest (the background job ``knob_tests``). With timing
     (``tools/train_variants.py``): ms per step, images/s, peak memory and
     launches per step of the variants on the graph route: ``pw_lowering``
     dot and conv in four alternating fresh builds (the faster one, or "within
     noise" where the means differ by no more than one lowering's spread),
     ``remat`` off and on at bs128 and bs512, the padded models, the dw
     routes; the serving forward per ``pw_lowering`` at bs1 and bs128 on
     the graph route, on the kernel route (whose fused blocks run no
     separate 1x1 conv) and on the torch route;
  9. trainer: the training harness, ``python -m mnasnet_tpu_torch.train``'s
     ``main(argv)`` in this process on the same production configuration
     (batch 128, bf16, 224 px, mnasnet1_0): (a) one epoch over a seeded
     ImageFolder of JPEGs (384 train images, 3 steps; 160 val images, a
     full batch and a padded tail of 32) with ``--bn-recalibrate 2`` and the
     ``native-fast`` decoder, checking 17 dw / 35 + 35 BN / 0 MBConv launches
     per train step that the counters see (the CLI trains on the default
     train route), 1 dw and 16 MBConv launches per validation forward that
     the counters see (before and after recalibration; the eval step is
     batch-routed, and a graph replay launches without its wrappers), 17 dw
     and nothing else per
     recalibration forward, finite losses, the checkpoints ``0/``, ``1/`` and
     ``best/``, and that ``python -m mnasnet_tpu_torch.eval DIR --resume OUT
     --best`` prints the acc1 the trainer printed for that checkpoint; (b)
     two ``--deterministic`` synthetic runs of 4 steps, one stopped by
     SIGTERM after step 2 and resumed: the final parameters, BN buffers,
     optimizer state and dropout generator bitwise equal to the
     uninterrupted run's; (c) images/s of 9 steps of ``Trainer.train_epoch``
     on synthetic data with the data path included, the loaders' batches/s
     with no model, the CPU count and the workers;
  9b. smoke: the train smoke's long-run path (``tools/train_smoke.py``
     with ``--state-file``, ``--chunk-epochs``, ``--train-rescore-size``;
     ``tools/bn_forensics.py``) at a small depth: mnasnet0_35@96, bs128,
     512 train and 256 val gratings, 2 epochs, BN EMA 0.9997, model EMA
     0.9999, ``--bn-recalibrate``, ``--train-rescore-size 256``,
     ``--deterministic`` (the trainer phase's bitwise-resume settings),
     each run a fresh process of this script (``--smoke-worker OUT ARGV``,
     TF32 off as here, the counts set to 0 just before ``main`` and read
     just after): straight, and chunked by ``--chunk-epochs 1`` (exit 3,
     then a second process that resumes from the state file, its code the
     straight run's), the straight run and the first chunk side by side.
     The straight run must take the default train route with exactly 17
     dw, 35 + 35 BN and 0 MBConv launches per counted step, and its
     validations must launch MBConv; the chunked state file must equal the
     straight one tensor for tensor (model, optimizer, train state, curve)
     and the curves must agree but for ``wall_seconds``.
     ``bn_forensics`` with 4 batches on the straight state, in this
     process while the second chunk runs: as
     many sites as the model has BatchNorms, pooled var = within +
     Var_b[mean_b] per channel to fp32 rounding, all four controls. A
     full run starts the straight run and the first chunk before the
     deadrank phase, beside it, and the rest after it;
 10. dist: data-parallel training on the same production configuration.
     (a) NCCL at world size 1: ``python -m torch.distributed.run --standalone
     --nproc_per_node 1 chip_smoke.py --dist-fixed OUT``, then ``...
     chip_smoke.py --dist-worker OUT ARGV`` (one group a process). In the
     first, on the fixed batch: the sync-BN, local-BN
     and sync-BN ``remat`` steps, 3 each with dropout, a changing rate and
     the model EMA under deterministic algorithms, on the graph route (the
     warm-up step, the capture with NCCL's all-reduces inside, two replays)
     bit for bit the eager route (losses, parameters, BN buffers with
     ``num_batches_tracked``, optimizer state, generator); then, in turns,
     ms per step and peak memory of the one-process step and the sync-BN
     step, each eager and on the graph route (and the eager sync-BN step
     with ``dist.all_reduce`` a no-op: what the port's own code around the
     collectives costs). In the second, the train CLI's ``main(ARGV)``
     (``--synthetic``, bf16, ``--fused-kernels kernel``, 12 steps of 128)
     with the environment torchrun gives it, on the graph route: every step
     must make exactly 17 / 35 / 35 / 0 launches per counted step and the
     collectives ``Trainer.collectives_per_step`` predicts per counted step,
     beside the stop flag each step issues eagerly (a graph's first call
     counts its warm-up and its capture, a replay nothing; the first step
     adds the epoch's stop flag and one check of each of the 5 BN plane
     sizes); images/s of steps 2-12 (2-9 with ``--profile``) beside the
     trainer phase's; with ``--profile`` the collectives' host time and
     NCCL's device time per step from a trace of steps 10-11, whose NCCL
     kernels per step must equal the step's collectives plus the stop
     flag's across ranks (none at world 1: NCCL launches no kernel for an
     in-place sum over one rank). (b) two ranks on the one card over gloo
     (both on cuda:0; gloo carries CUDA tensors for all_reduce and
     broadcast, the only collectives of the port; its collectives run on
     the host, so its route is eager), fp32, TF32 off, kernel route, 64
     images a rank of the train phase's fixed batch: the sync-BN step
     against the one-process step on the 128 (dropout on), the local-BN
     step against the one-process ``grad_accum=2`` step; each rank must
     make 17 / 35 / 35 / 0 launches per step, and the two ranks must end
     with the same state, bit for bit.
     Gloo is only the way to two ranks on one card, never a stand-in for a
     failed NCCL run. (c) ``mnasnet_tpu_torch.entry.dryrun_multichip(1)``:
     the dry run's tiny sync-BN and local-BN steps and the production-shape
     capture, on the card. On a machine with N cards all three run over
     NCCL at world N instead, one card a rank: (a) at 128 images a rank,
     the graph route bit for bit eager on every rank, and no no-op
     collective; (b) with the 128 split N ways, on the graph route, local
     BN against ``grad_accum=N``; (c) ``dryrun_multichip(N)``. (b) and (c)
     are the background jobs ``dist_ranks`` and ``dist_dryrun``.
 10b. spatial: the ``data x spatial`` mesh (``parallel/mesh.py``,
     ``parallel/spatial.py``) on the same production configuration. (a)
     Two gloo ranks on cuda:0 as a 1x2 mesh, each on its band of 112 of the
     224 rows of the train phase's 128 images, take one bf16 sync-BN step
     against one process's on the whole batch, to the compile route's bf16
     bars (``_held_to_one_ulp``); each rank's launches against the band
     plan (17 dw, 35 + 35 BN, 0 MBConv: every band of mnasnet1_0@224 has
     rows), its collectives against ``step_collectives`` with the halo
     exchanges and pooled sums, its peak memory beside one process's, and
     ms per step after the first (both ranks on one card: the card is
     shared). (b) The eval forward of the serving phase's weights over the
     same mesh, the fused MBConv and dw kernels launched on each band's
     window (16 + 1 a forward), against one process's logits to the
     serving phase's bf16 rule, the two ranks' logits bit for bit. (c) On a
     machine with four cards: a 2x2 mesh over NCCL, a card a rank, on the
     graph route (the halo all-reduces captured in the graph) bit for bit
     the eager route over 3 steps with dropout, a changing rate and the
     model EMA. (d) With timing: the fused MBConv kernel's device time at
     each of the 16 block shapes on the whole plane and on each band's
     window with its crop (CUDA-graph replays), their sums over the blocks;
     not a gate;
 11. deadrank: a dead rank and the recovery, through the train CLI on the
     same production configuration (synthetic, ``DEADRANK_STEPS`` steps of
     128 images a rank an epoch, the kernel route, ``DEADRANK_EPOCHS``
     epochs; ``mnasnet_tpu_torch/tools/deadrank_probe.py:kill_run``). (a)
     Two gloo ranks as processes of their own on cuda:0 (global batch 256;
     gloo cannot be captured, so the eager route); once rank 0 prints
     step ``DEADRANK_KILL_STEP`` of epoch 1 (the steps after it already
     issued, mid-epoch) and the epoch-0 checkpoint is on disk, rank 1 is
     SIGKILLed, and rank 0 must exit non-zero within
     ``DEADRANK_GLOO_BOUND_S``. (b) In this process, one process
     ``--resume``s that checkpoint at global batch 256 and finishes the
     run on the default (graph) route: exactly 17 dw, 35 bn_bwd_reduce,
     35 bn_bwd_dx, 35 of each BN forward kernel and 0 MBConv launches per
     counted train step, the counts
     set to 0 just before and read just after, every kernel of the path
     launched. (c) On a machine with two or more cards: two NCCL ranks,
     one card each, on the graph route (the step's all-reduces replayed
     from a CUDA graph, which no watchdog watches); rank 1 is SIGKILLed
     at the same point, while rank 0 replays steps, and rank 0 must exit non-zero
     within ``DIST_TIMEOUT_S`` + 60 s, ended by the host's deadline
     (``parallel/dist.py:Deadline``: exit 1 once the event behind a replay
     or an eager collective is ``DIST_TIMEOUT_S`` old). Each child has a
     hard time limit.
 12. tools: each measurement tool of ``mnasnet_tpu_torch/tools`` once, in
     this process, at a reduced size (``TOOL_RUNS``): ``memory_probe`` at B
     256 with K 1 and 2 (17K dw, 35K + 35K BN and 0 MBConv launches per
     counted step; K 2 saving at most 0.55 of K 1's activations),
     ``bench_latency`` and ``export_latency`` at bs 1 and 128 on the graph
     route (1 dw and 16 MBConv launches per serving forward on the kernel
     route, none on the torch route; the artifact's eager logits bit for
     bit the live forward's), ``e2e_infer`` on 512 JPEGs with one loader
     worker and PIL, and ``sweep_grid`` at 0.35@96 and 1.4@224, serving
     only (16 fused blocks and 1 dw launch a forward, no shape refused);
     each record's keys, and the card's name and power limit in it.
A full run takes the phases in this order: device, build, dw, mbconv,
serving, bn, dw training op, b4; then it starts the background jobs
(``FARM_JOBS``: the compile routes' first steps, the compilation cache, the
knobs' GPU tests, the dist phase's ranks and dry run, each a process of its
own at a lower priority) and takes, beside them, the checks that run no
timing window: serve's, train's and knobs' checks, deadrank (whose bounds
are tens of seconds), and smoke (whose first two processes run beside
deadrank); it waits for the jobs, then times the serving routes, the train
routes and the knobs' variants and runs trainer, dist, spatial and tools,
with no job left running beside any timing window.
It then prints the ``kernels`` JSON line (the b4 phase's kernels at the
end), the card line, and as its last line
``{"ok": true, "device": {...}}``. A kernel's "ms" (and its plain version's
and library call's) is the time per call from CUDA events over back-to-back
eager calls through the counted wrapper, as the model makes them: where the
host takes longer to issue a call than the card to run it, the host's time
counts; "host_ms" beside it is the host's time per call alone. ``--profile``
gives the device time of each of the port's kernels per forward and step.
The dw kernel's training sums are also given by stride (``train_step_s1_*``,
``train_step_s2_*``).

Tolerances (normalised by the largest magnitude of the reference):
  * kernel vs plain version, fp32: 1e-5 (dw) and 1e-4 (MBConv) — the same
    fp32 arithmetic summed in another order;
  * kernel vs plain version, bf16: 2^-7 (dw) and 2^-6 (MBConv) — one and two
    bf16 ulps at the largest output, for roundings that flip where the fp32
    sums differ in their last bit;
  * whole model, fp32, kernel route vs torch route: 1e-4;
  * BN backward kernels vs plain versions: dγ and dβ 1e-4 in both dtypes
    (fp32 sums of the same terms over up to 1.6 M rows, in another order),
    dx 1e-4 (fp32) and 2^-7 (bf16, one ulp where the fp32 values differ in
    their last bits); the mask counts exactly;
  * dw training op vs torch route: dx 1e-4 (fp32) and 2^-7 (bf16); dw 1e-4
    (fp32) and 2^-6 (bf16: the torch route rounds its weight gradient to
    bf16, the Function sums in fp32);
  * the first bf16 step of the compile route (compiled once) vs eager
    from the same weights: loss within 1e-5 relative, the BN running
    statistics (moments as the dist bars below read them) within
    1e-5, and the update within 1e-2 relative RMS, or each within 4 times
    the eager step's own move when its images change by one bf16 ulp,
    whichever is larger (Inductor rounds its fused bf16 arithmetic once
    where eager rounds every op). At random init that one-ulp move shifts
    the bf16 update by about its own size (measured: 1.17 relative RMS), so
    the loss and the moments carry this check; the update is held in fp32,
    at the fp32 bars, by ``tests/test_torch_gpu.py`` at a small size;
  * one fp32 training step, kernel route vs torch route: loss within 1e-5
    relative, BN running statistics within 1e-5 relative, and the parameter
    update p - p0 within 1e-2 relative RMS over all parameters (the
    elementwise count outside rtol 5e-3 / atol 1e-4 is printed: at random
    init a 1e-7 forward difference can flip a ReLU mask and move single
    gradient elements by more);
  * train routes: the graph route and a mix of routes bit for bit the eager
    route (the same kernels on the same inputs in the same order);
  * knobs: ``remat`` bit for bit (the recompute runs the same kernels on
    the same inputs; the BN statistics update once, outside it); the
    compile route with ``remat``, the dw routes and the padded kernel route
    against their references within the compile route's bf16 bars above
    (``_held_to_one_ulp``);
  * trainer: launches and checkpoints exactly, the eval CLI's acc1 equal to
    the trainer's as printed (3 decimals), the resumed run bit for bit;
  * spatial: launches and collectives exactly, the ranks bit for bit; the
    1x2 step against one process to ``_held_to_one_ulp``'s bf16 bars (the
    sums of the bands are taken in another order, as the dist phase's
    ranks'), the eval logits to the serving phase's bf16 rule;
  * dist: launches and collectives exactly; the graph route bit for bit
    eager at every world; the ranks against one process:
    loss within 1e-5 relative, the step's BN moments within 1e-5 (each mean
    in units of its channel's standard deviation, each variance relative),
    the update within 1e-2 relative RMS (the fp32 kernel-vs-torch step's
    bound) or 4 times the one-process step's own move when its images
    change by one ulp, whichever is larger: the same math with the moments'
    and the gradients' sums taken in another order, a rounding that the
    batch-statistic BN backward amplifies at random init as it amplifies
    that one-ulp change (measured: 8.4e-3 against an own move of 9.5e-3);
  * tools: launches, keys and the artifact's logits exactly;
  * smoke: launches and the chunked state bit for bit; the forensics'
    pooled variance equal to within + between within 2^-22 relative (the
    same fp32 sums, added once more);
  * deadrank: the survivor's exit non-zero within 60 s over gloo (a dead
    peer's socket closes, so its next collective raises at once) and
    within ``DIST_TIMEOUT_S`` + 60 s over NCCL (the host deadline's
    timeout, its poll and the exit); the resumed run's launches exactly;
  * whole model, bf16: max |kernel route - torch route| <= 0.25 of the
    largest logit, and the kernel route's relative RMS error against the fp32
    reference at most 1.25x the torch route's plus 0.01. Random weights make
    logits that lie close together, so bf16 rounding moves the top-1 of many
    images on either route; the top-1 agreement is printed, and held to 0.5.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.data import native_decoder
from mnasnet_tpu_torch.data.dataset import ImageFolderDataset, SyntheticDataset
from mnasnet_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
from mnasnet_tpu_torch.data.transforms import eval_transform, train_transform
from mnasnet_tpu_torch.entry import dryrun_multichip
from mnasnet_tpu_torch.models.layers import PW_AUTO, BatchNorm, nchw, set_replicas
from mnasnet_tpu_torch.ops.cuda import _build
from mnasnet_tpu_torch.ops.cuda.bn_bwd import (
    _fwd_math,
    _fwd_region,
    apply_plan,
    batch_moments,
    bn_bwd_dx,
    bn_bwd_dx_reference,
    bn_bwd_reduce,
    bn_bwd_reduce_reference,
    bn_fwd_stats,
    bn_fwd_stats_reference,
    bn_relu_apply,
    bn_relu_apply_reference,
    reduce_plan,
    region_moments,
    relu_mask_reference,
    stats_plan,
)
from mnasnet_tpu_torch.ops.cuda.dw_conv import (
    depthwise_conv_train,
    dw_conv_bn_act,
    dw_conv_reference,
    out_size,
)
from mnasnet_tpu_torch.ops.cuda.dw_conv import launch as dw_launch
from mnasnet_tpu_torch.ops.cuda.dw_conv import plan as dw_plan
from mnasnet_tpu_torch.ops.cuda.mbconv import kernel_args, mbconv_fused, mbconv_reference, plan
from mnasnet_tpu_torch.ops.cuda.mbconv import launch as mb_launch
from mnasnet_tpu_torch.ops.depthwise import depthwise_conv2d
from mnasnet_tpu_torch.parallel import (
    all_reduce_max_,
    close,
    dist_timeout,
    init_distributed,
    make_mesh,
    shard_batch,
    use_mesh,
)
from mnasnet_tpu_torch.parallel.spatial import bands, conv_windows
from mnasnet_tpu_torch.serving import load_serving
from mnasnet_tpu_torch.tools import (
    bench_latency,
    bn_forensics,
    deadrank_probe,
    e2e_infer,
    export_latency,
    memory_probe,
    multihost,
    sweep_grid,
    train_smoke,
)
from mnasnet_tpu_torch.tools.tune_plans import (
    BATCH,
    IMAGE,
    block_shapes,
    bn_region_shapes,
    dw_shapes,
    random_block,
    time_ms,
    train_dw_shapes,
)
from mnasnet_tpu_torch.train import __main__ as train_cli
from mnasnet_tpu_torch.train import bn_recal
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.schedules import make_schedule
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import (
    make_local_bn_train_step,
    make_predict_fn,
    make_train_step,
    step_collectives,
)
from mnasnet_tpu_torch.tools.export_serving import build_forward, export_artifact
from mnasnet_tpu_torch.tools.train_variants import (
    COUNTERS,
    VARIANTS,
    counts,
    memory_base,
    time_serving,
    time_train,
)
from mnasnet_tpu_torch.tools.train_variants import train_batch as variant_batch
from mnasnet_tpu_torch.train.trainer import Trainer
from mnasnet_tpu_torch.utils.card import card_line
from mnasnet_tpu_torch.utils.routing import (
    GRAPH_WARMUP,
    ROUTES,
    SERVE_ROUTE_BATCH_RANGES,
    TRAIN_ROUTE,
)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense bf16 tensor-core rate
              "float32": 67e12}    # fp32 outside the tensor cores (TF32 off)
TOL_DW = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TOL_MB = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
TOL_BN_SUMS = {"float32": 1e-4, "bfloat16": 1e-4}
TOL_BN_DX = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
TOL_DW_TRAIN = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -6)}  # (dx, dw)
BN_EPS = 1e-5
# The SiLU apply against its plain version (the same two-op bf16 z, then
# SiLU): within one rounding of the output dtype at the largest value.
TOL_SILU_APPLY = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
# The b4 phase: efficientnet_b4 at its published 380 px and the train cell's
# batch, with EfficientNet's BN epsilon; per counted step of its train
# route, 64 BN+SiLU regions (stats and the SiLU apply, reduce and dx), 32 dw
# kernels, no ReLU region kernel and no fused MBConv.
B4_IMAGE = 380
B4_BATCH = 64
B4_BN_EPS = 1e-3
B4_LAUNCHES_PER_STEP = {"dw_conv_bn_act": 32, "mbconv_block": 0, "bn_fwd_stats": 64,
                        "bn_relu_apply.silu": 64, "bn_bwd_reduce.silu": 64,
                        "bn_bwd_dx.silu": 64, "bn_relu_apply.relu": 0,
                        "bn_bwd_reduce.relu": 0, "bn_bwd_dx.relu": 0}
# The production train configuration (bench.py's "optimized" build): the
# learning rate its RMSProp is timed at.
TRAIN_LR = 0.01
TRAIN_STEPS = 5
LAUNCHES_PER_STEP = {"dw_conv_bn_act": 17, "bn_bwd_reduce": 35, "bn_bwd_dx": 35,
                     "mbconv_block": 0, "bn_fwd_stats": 35, "bn_relu_apply": 35}
# Under --deterministic (two_pass statistics) the stats kernel runs twice a
# region.
LAUNCHES_PER_TWO_PASS_STEP = dict(LAUNCHES_PER_STEP, bn_fwd_stats=70)
# With remat each of the 16 blocks runs its dw kernel and its two BN+ReLU
# regions' forward kernels again in the backward.
LAUNCHES_PER_REMAT_STEP = dict(LAUNCHES_PER_STEP, dw_conv_bn_act=17 + 16,
                               bn_fwd_stats=35 + 32, bn_relu_apply=35 + 32)
KNOB_STEPS = 3
REMAT_BIG_BATCH = 512
KNOB_TARGET_MS = 500.0
# conv and dot in alternating runs, each a fresh build.
PW_ORDER = ("dot", "conv", "conv", "dot")
# The port's kernels by a part of their CUDA function names, for profiles.
KERNEL_NAMES = {"dw_conv_bn_act": "dw_conv_kernel", "mbconv_block": "mbconv_",
                "bn_bwd_reduce": "bn_reduce_", "bn_bwd_dx": "bn_dx_kernel",
                "bn_fwd_stats": "bn_stats_kernel", "bn_relu_apply": "bn_apply_relu_kernel"}
REPO = Path(__file__).resolve().parent
# The trainer phase's ImageFolder: classes, train and val images per class.
FOLDER_CLASSES, FOLDER_TRAIN, FOLDER_VAL = 8, 48, 20
LAUNCHES_PER_VAL_FORWARD = {"dw_conv_bn_act": 1, "bn_bwd_reduce": 0, "bn_bwd_dx": 0,
                            "mbconv_block": 16, "bn_fwd_stats": 0, "bn_relu_apply": 0}
LAUNCHES_PER_RECAL_FORWARD = {"dw_conv_bn_act": 17, "bn_bwd_reduce": 0, "bn_bwd_dx": 0,
                              "mbconv_block": 0, "bn_fwd_stats": 35, "bn_relu_apply": 35}
THROUGHPUT_STEPS = 10
DIST_STEPS = 12
# The fixed-batch data-parallel runs: their kinds held graph against eager,
# the steps of each, and the steps timed per kind (the same on every rank).
DP_KINDS = ("sync", "local", "sync_remat")
DP_STEPS = 3
DP_TIMED = 10
# The bound on one torchrun worker's whole run (the fixed-batch runs and the
# CLI's epoch take ~1-2 minutes at world 1).
DIST_WORKER_S = 300
# The torchrun run's profiled window, steps 10 and 11 of 12 (the profiler
# stops before the last step): starting and stopping it takes seconds and
# leaves the process slower, so the images/s are those of the steps before.
DIST_PROFILE_STEPS = (DIST_STEPS - 3, DIST_STEPS - 1)
# The BN planes of mnasnet1_0@224 (112², 56², 28², 14², 7²): sync-BN checks
# each size once, on the first step.
BN_PLANE_SIZES = 5
# The deadrank phase: steps of BATCH images a rank an epoch, epochs (rank 1
# dies in epoch 1, the resume runs the rest), the step of epoch 1 whose
# printed line kills rank 1 (metrics print one step late, so the next step
# is issued by then and more remain: the kill lands mid-epoch, among the
# survivor's replays), the bound on the ranks' reaching it, and on the gloo
# survivor's exit (its collective raises as soon as the dead peer's socket
# closes).
DEADRANK_STEPS = 8
DEADRANK_EPOCHS = 3
DEADRANK_KILL_STEP = 3
DEADRANK_START_S = 300
DEADRANK_GLOO_BOUND_S = 60
# The smoke phase: the train smoke's long-run path at a small depth, and the
# bound on each of its processes.
SMOKE_ARGV = ["--arch", "mnasnet0_35", "--image-size", "96", "--batch-size", "128",
              "--train-size", "512", "--val-size", "256", "--epochs", "2",
              "--bn-momentum", "0.9997", "--model-ema", "0.9999", "--bn-recalibrate",
              "--train-rescore-size", "256", "--deterministic", "--workers", "4"]
SMOKE_FORENSICS_BATCHES = 4
SMOKE_WORKER_S = 300
SMOKE_WORK = REPO / "build" / "chip_smoke_smoke"


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: int, flops: int, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-30))


def host_ms(fn, iters: int = 50) -> float:
    """Host time of one call of ``fn``: the wall time of issuing ``iters``
    calls without waiting for the card, fewer than its launch queue holds.
    Where it reaches the call's ``time_ms``, the host sets that time, not
    the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def _dw_bytes(x, ho, c, k) -> int:
    """Bytes the dw kernel must move: x read and y written once, the fp32
    weights, scale and bias read once."""
    return (x.numel() + BATCH * ho * ho * c) * x.element_size() + (k * k + 2) * c * 4


def dw_phase(timing: bool) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for h, c, k, s in dw_shapes():
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            x = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(dt)
            w = torch.randn(k, k, 1, c, device="cuda", generator=g) * 0.3
            scale = torch.rand(c, device="cuda", generator=g) + 0.5
            bias = torch.randn(c, device="cuda", generator=g) * 0.1
            y = dw_conv_bn_act(x, w, scale, bias, stride=s, relu=True)
            ref = dw_conv_reference(x, w, scale, bias, stride=s, relu=True)
            torch.cuda.synchronize()
            if y.shape != ref.shape or y.dtype != dt or not torch.isfinite(y).all():
                raise RuntimeError(f"dw {h}x{h}x{c} k{k} s{s} {name}: bad output")
            err = rel_err(y, ref)
            p = dw_plan(BATCH, h, h, c, k, s, x.element_size())
            row = {"shape": f"{h}x{h}x{c} k{k} s{s}", "dtype": name,
                   "max_abs_err": float((y.float() - ref.float()).abs().max()),
                   "rel_err": err, "tol": TOL_DW[name], "plan": p._asdict()}
            if err > TOL_DW[name]:
                raise RuntimeError(f"dw {row['shape']} {name}: error {err:.3g} > {TOL_DW[name]}")
            ho = out_size(h, k, s)
            row["bound_ms"], row["bound_by"] = bound(
                _dw_bytes(x, ho, c, k), 2 * k * k * BATCH * ho * ho * c, name)
            if timing:
                row["ms"] = time_ms(lambda: dw_conv_bn_act(x, w, scale, bias, stride=s))
                row["host_ms"] = host_ms(lambda: dw_conv_bn_act(x, w, scale, bias, stride=s))
                # The direct launch() on prepared operands: the op's checks and
                # the dispatcher are the difference.
                ops32 = (w.reshape(k, k, c).float().contiguous(), scale.float().contiguous(),
                         bias.float().contiguous())
                row["launch_host_ms"] = host_ms(lambda: dw_launch(x, *ops32, s, True, p))
                row["plain_ms"] = time_ms(lambda: dw_conv_reference(x, w, scale, bias, stride=s))
                # One cuDNN call for the same conv and affine (no ReLU): the
                # scale folded into the weights, the bias as the conv bias.
                xc = x.permute(0, 3, 1, 2)
                wf = (w.reshape(k, k, c) * scale).permute(2, 0, 1).unsqueeze(1).to(dt)
                bf = bias.to(dt)
                row["library_ms"] = time_ms(
                    lambda: F.conv2d(xc, wf, bf, stride=s, padding=k // 2, groups=c))
            log(f"[dw] {row}")
            rows.append(row)
            del x, y, ref
    return rows


DW_SUMS = ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms")


def dw_train_timing() -> dict:
    """The dw kernel as one training step runs it: the 17 depthwise convs of
    the forward (``train_dw_shapes``), bf16, unit scale, zero bias, no ReLU,
    through ``dw_conv_bn_act``. Sums over the step of the kernel's time, its
    host time, its bound, its plain version and one cuDNN call of the same
    conv (``F.conv2d(groups=C)``, no bias); the same sums by stride under
    ``"s1"`` (``_dw_s1_kernel``'s launches) and ``"s2"``."""
    g = torch.Generator(device="cuda").manual_seed(7)
    shapes = train_dw_shapes()
    out = {"summed_over": len(shapes), "max_abs_err": 0.0, **dict.fromkeys(DW_SUMS, 0.0)}
    for stride in (1, 2):
        out[f"s{stride}"] = {"summed_over": sum(1 for sh in shapes if sh[3] == stride),
                             **dict.fromkeys(DW_SUMS, 0.0)}
    for (h, c, k, s) in sorted(set(shapes)):
        times = shapes.count((h, c, k, s))
        one = {}
        x = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(k, k, 1, c, device="cuda", generator=g) * 0.3
        ones = torch.ones(c, device="cuda")
        zeros = torch.zeros(c, device="cuda")
        y = dw_conv_bn_act(x, w, ones, zeros, stride=s, relu=False)
        ref = dw_conv_reference(x, w, ones, zeros, stride=s, relu=False)
        err = rel_err(y, ref)
        if err > TOL_DW["bfloat16"]:
            raise RuntimeError(f"dw training form {h}x{h}x{c} k{k} s{s}: error {err:.3g}")
        out["max_abs_err"] = max(out["max_abs_err"], float((y.float() - ref.float()).abs().max()))
        ho = out_size(h, k, s)
        one["bound_ms"] = bound(_dw_bytes(x, ho, c, k), 2 * k * k * BATCH * ho * ho * c,
                                "bfloat16")[0]
        xc = x.permute(0, 3, 1, 2)
        wc = w.reshape(k, k, c).permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)
        for key, fn in (("ms", lambda: dw_conv_bn_act(x, w, ones, zeros, stride=s, relu=False)),
                        ("plain_ms", lambda: dw_conv_reference(x, w, ones, zeros, stride=s,
                                                               relu=False)),
                        ("library_ms", lambda: F.conv2d(xc, wc, None, stride=s,
                                                        padding=k // 2, groups=c))):
            one[key] = time_ms(fn, 30.0)
        one["host_ms"] = host_ms(lambda: dw_conv_bn_act(x, w, ones, zeros, stride=s, relu=False))
        for key in DW_SUMS:
            out[key] += times * one[key]
            out[f"s{s}"][key] += times * one[key]
        del x, y, ref, xc
    log(f"[dw] training step, {out['summed_over']} launches: {out}")
    return out


def mbconv_phase(timing: bool) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name_b, h, cin, cmid, cout, k, s in block_shapes():
        block, (x32, *weights), kw = random_block(h, cin, cmid, cout, k, s, g)
        ho = out_size(h, k, s)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            x = x32.to(dt)
            args = (x, *weights)
            with torch.no_grad():
                y = mbconv_fused(*args, **kw)
                ref = mbconv_reference(*args, **kw)
            torch.cuda.synchronize()
            if y.shape != (BATCH, ho, ho, cout) or not torch.isfinite(y).all():
                raise RuntimeError(f"mbconv {name_b} {name}: bad output")
            err = rel_err(y, ref)
            p = plan(h, h, cin, cmid, cout, k, s, x.element_size())
            row = {"block": name_b, "shape": f"{h}x{h} {cin}->{cmid}->{cout} k{k} s{s}",
                   "dtype": name, "max_abs_err": float((y.float() - ref.float()).abs().max()),
                   "rel_err": err, "tol": TOL_MB[name],
                   "plan": {"th": p.th, "tw": p.tw, "mc": p.mc, "threads": p.threads,
                            "smem": p.smem, "expand_recompute": p.expand_px / (h * h)}}
            if err > TOL_MB[name]:
                raise RuntimeError(f"mbconv {name_b} {name}: error {err:.3g} > {TOL_MB[name]}")
            nbytes = ((x.numel() + BATCH * ho * ho * cout) * x.element_size()
                      + (cin * cmid + k * k * cmid + cmid * cout) * x.element_size()
                      + (4 * cmid + 2 * cout) * 4)
            flops = 2 * BATCH * (h * h * cin * cmid + ho * ho * (k * k * cmid + cmid * cout))
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, name)
            if timing and dt == torch.bfloat16:
                with torch.no_grad():
                    row["ms"] = time_ms(lambda: mbconv_fused(*args, **kw))
                    row["host_ms"] = host_ms(lambda: mbconv_fused(*args, **kw))
                    ka = kernel_args(*args, kernel_size=k)
                    row["launch_host_ms"] = host_ms(
                        lambda: mb_launch(*ka, stride=s, residual=kw["residual"], p=p))
                    row["plain_ms"] = time_ms(lambda: mbconv_reference(*args, **kw))
                    # The port's "torch" route for the whole block, as the model runs it.
                    xc = nchw(x)
                    row["torch_route_ms"] = time_ms(lambda: block(xc))
            log(f"[mbconv] {row}")
            rows.append(row)
            del x, y, ref
    return rows


def calibrate_bn(model, images) -> None:
    """Set every BN's running statistics to the batch statistics of its input
    on ``images``, in one forward (each BN then normalises what it sees):
    random weights with the init's unit statistics make activations vanish."""
    def hook(bn, args):
        v = args[0].float()
        bn.running_mean.copy_(v.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(v.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for hd in handles:
            hd.remove()


def serving_weights(g: torch.Generator):
    """The serving phase's weights: mnasnet1_0 from seed 0 with its BN
    statistics calibrated on 32 random images drawn from ``g``; returns the
    fp32 torch-route model and its state_dict."""
    ref32 = create_model("mnasnet1_0", dtype=torch.float32, dw_impl="torch", seed=0)
    calib = torch.randn(32, 3, IMAGE, IMAGE, device="cuda", generator=g)
    calibrate_bn(ref32, calib)
    return ref32, ref32.state_dict()


def serving_phase(timing: bool, card: str, profile_dir: Path | None) -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    ref32, state = serving_weights(g)

    def model(dtype, impl):
        m = create_model("mnasnet1_0", dtype=dtype, dw_impl=impl, seed=0)
        m.load_state_dict(state)
        return m

    served = model(torch.bfloat16, "auto")
    predict = make_predict_fn(served)
    batches = [torch.randn(BATCH, IMAGE, IMAGE, 3, device="cuda", generator=g) for _ in range(3)]

    # The main path: counts set to 0 just before, read just after.
    dw_conv_bn_act.launches = 0
    mbconv_fused.launches = 0
    logits = [predict(b) for b in batches]
    torch.cuda.synchronize()
    launches = {"dw_conv_bn_act": dw_conv_bn_act.launches, "mbconv_block": mbconv_fused.launches}
    log(f"[serving] launches over {len(batches)} forwards: {launches}")
    if launches != {"dw_conv_bn_act": len(batches), "mbconv_block": 16 * len(batches)}:
        raise RuntimeError(f"expected 1 dw and 16 MBConv launches per forward, got {launches}")

    out = {"launches": launches}
    torch_bf16 = make_predict_fn(model(torch.bfloat16, "torch"))
    kernel_32 = make_predict_fn(model(torch.float32, "kernel"))
    ref_fn = make_predict_fn(ref32)
    k_all = torch.cat(logits)
    t_all = torch.cat([torch_bf16(b) for b in batches])
    f_all = torch.cat([ref_fn(b) for b in batches])
    k32_all = torch.cat([kernel_32(b) for b in batches])
    for name, v in (("kernel_bf16", k_all), ("torch_bf16", t_all), ("kernel_fp32", k32_all)):
        if v.shape != (len(batches) * BATCH, 1000) or v.dtype != torch.float32 \
                or not torch.isfinite(v).all():
            raise RuntimeError(f"{name} logits: bad output {tuple(v.shape)} {v.dtype}")

    def rrms(a, b):
        return float((a - b).norm() / b.norm())

    out["fp32_kernel_vs_torch_rel_err"] = rel_err(k32_all, f_all)
    out["fp32_top1_agreement"] = float((k32_all.argmax(-1) == f_all.argmax(-1)).float().mean())
    out["bf16_max_abs_diff"] = float((k_all - t_all).abs().max())
    out["bf16_tol"] = 0.25 * float(t_all.abs().max())
    out["bf16_top1_agreement"] = float((k_all.argmax(-1) == t_all.argmax(-1)).float().mean())
    out["bf16_kernel_rel_rms_vs_fp32"] = rrms(k_all, f_all)
    out["bf16_torch_rel_rms_vs_fp32"] = rrms(t_all, f_all)
    log(f"[serving] agreement: {json.dumps(out)}")
    if out["fp32_kernel_vs_torch_rel_err"] > 1e-4:
        raise RuntimeError("fp32 kernel route disagrees with the torch route")
    if out["bf16_max_abs_diff"] > out["bf16_tol"]:
        raise RuntimeError("bf16 kernel route disagrees with the torch route")
    if out["bf16_kernel_rel_rms_vs_fp32"] > 1.25 * out["bf16_torch_rel_rms_vs_fp32"] + 0.01:
        raise RuntimeError("bf16 kernel route is further from fp32 than the torch route")
    if out["bf16_top1_agreement"] < 0.5:
        raise RuntimeError("bf16 kernel route and torch route agree on top-1 for under half")

    # One single-image request: a seeded PIL image through the eval transform.
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    probs = torch.softmax(predict(eval_transform(img, IMAGE)[None]), dim=-1)[0]
    top = torch.topk(probs, 5)
    out["single_image_top5"] = [[int(i), round(float(p), 6)]
                                for p, i in zip(top.values, top.indices)]
    log(f"[serving] single image top-5: {out['single_image_top5']}")

    if timing:
        x, x1 = batches[0], batches[0][:1]
        for name, fn in (("kernel", predict), ("torch", torch_bf16)):
            ms = time_ms(lambda: fn(x), target_ms=1000.0)
            out[f"{name}_route_ms_per_batch"] = ms
            out[f"{name}_route_images_per_s"] = BATCH / ms * 1e3
            out[f"{name}_route_ms_single_image"] = time_ms(lambda: fn(x1), target_ms=200.0)
            if profile_dir is not None:
                out[f"{name}_route_profile"] = profile_forward(
                    fn, x, profile_dir / f"profile_{name}_route.txt")
        log(f"[serving] bs{BATCH} bf16 images/s: kernel route "
            f"{out['kernel_route_images_per_s']:.1f}, torch route "
            f"{out['torch_route_images_per_s']:.1f}; bs1 ms: kernel route "
            f"{out['kernel_route_ms_single_image']:.3f}, torch route "
            f"{out['torch_route_ms_single_image']:.3f} on {card}")
    return out


# The serve phase's sizes: every route is timed at SERVE_SIZES, the compile
# route (a compile of the whole forward per size) at COMPILE_SIZES only.
SERVE_SIZES = (1, 8, 32, 128)
COMPILE_SIZES = (1, 128)
FIXED_BATCH = 8  # the fixed-batch artifact of the wrong-shape check

# (a): in a fresh interpreter that imports only mnasnet_tpu_torch.serving, the
# artifact on the eager route: its logits at bs128, the launches of each of
# 3 calls, and a wrong batch on the fixed-batch artifact.
_SERVE_CHILD = """
import json, sys
import torch
from mnasnet_tpu_torch import serving
art, fixed, x_path, out_path = sys.argv[1:5]
predict = serving.load_serving(art, route="eager")
x = torch.load(x_path).cuda()
counters = {"dw_conv_bn_act": serving.dw_conv.dw_conv_bn_act,
            "mbconv_block": serving.mbconv.mbconv_fused}
res = {"per_call": []}
for fn in counters.values():
    fn.launches = 0
for _ in range(3):
    before = {k: fn.launches for k, fn in counters.items()}
    y = predict(x)
    torch.cuda.synchronize()
    res["per_call"].append({k: fn.launches - before[k] for k, fn in counters.items()})
res["launches"] = {k: fn.launches for k, fn in counters.items()}
torch.save(y.cpu(), out_path)
try:
    serving.load_serving(fixed, route="eager")(x[:3])
    res["wrong_shape"] = None
except Exception as e:
    res["wrong_shape"] = f"{type(e).__name__}: {str(e)[:200]}"
print(json.dumps(res))
"""

# (c): one compile of the artifact at bs 1 with --compilation-cache DIR.
_CACHE_CHILD = """
import json, sys, time
import torch
from mnasnet_tpu_torch import serving
from mnasnet_tpu_torch.utils.compilation_cache import enable_compilation_cache
cache, art = sys.argv[1:3]
enable_compilation_cache(cache)
predict = serving.load_serving(art, route="compile")
x = torch.randn(1, 224, 224, 3, device="cuda")
t0 = time.perf_counter()
predict(x)
torch.cuda.synchronize()
print(json.dumps({"first_call_s": time.perf_counter() - t0}))
"""


def _child(code: str, args: list, timeout: int = 600) -> dict:
    r = subprocess.run([sys.executable, "-c", code, *map(str, args)], cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"child rc {r.returncode}:\n{r.stdout[-2000:]}{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def route_table(rows: list) -> tuple:
    """``SERVE_ROUTE_BATCH_RANGES`` as the timings give it: the fastest route
    at each measured size rules from that size up to the next one."""
    ranges = []
    for i, row in enumerate(rows):
        hi = rows[i + 1]["bs"] - 1 if i + 1 < len(rows) else 1 << 30
        if ranges and ranges[-1][2] == row["fastest"]:
            ranges[-1] = (ranges[-1][0], hi, row["fastest"])
        else:
            ranges.append((row["bs"] if i else 1, hi, row["fastest"]))
    return tuple(ranges)


def serve_phase() -> tuple[dict, dict]:
    """The serving deployment's checks: export, a fresh process's load, each
    route; returns the record and the routes and images that
    :func:`serve_timing` times. (c) is the background job ``serve_cache``."""
    g = torch.Generator(device="cuda").manual_seed(3)
    _, state = serving_weights(g)
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, device="cuda", generator=g)
    work = Path(tempfile.mkdtemp(prefix="serve_", dir=REPO / "build"))
    out: dict = {}
    try:
        # (a) export, then load and run in a fresh process.
        fn, x = build_forward("mnasnet1_0", 1000, "bfloat16", state, IMAGE, BATCH,
                              device="cuda")
        t0 = time.perf_counter()
        data = export_artifact(fn, x, symbolic_batch=True)
        out["export_s"] = time.perf_counter() - t0
        out["artifact_mb"] = len(data) / 1e6
        art, fixed = work / "model.pt2", work / "model_b8.pt2"
        art.write_bytes(data)
        fixed.write_bytes(export_artifact(fn, x[:FIXED_BATCH].contiguous()))
        torch.save(images.cpu(), work / "x.pt")
        served = create_model("mnasnet1_0", dtype=torch.bfloat16, dw_impl="auto", seed=0)
        served.load_state_dict(state)
        live = make_predict_fn(served)(images)
        child = _child(_SERVE_CHILD, [art, fixed, work / "x.pt", work / "y.pt"])
        log(f"[serve] fresh process: {json.dumps(child)}")
        out["artifact"] = child
        got = torch.load(work / "y.pt")
        if not torch.equal(got, live.cpu()):
            raise RuntimeError(f"the artifact's bs{BATCH} logits differ from the live forward: "
                               f"max {float((got - live.cpu()).abs().max())}")
        if any(c != {"dw_conv_bn_act": 1, "mbconv_block": 16} for c in child["per_call"]):
            raise RuntimeError(f"artifact launches per call {child['per_call']}, expected 1 + 16")
        if child["wrong_shape"] is None:
            raise RuntimeError("the fixed-batch artifact accepted a batch of 3")

        # (b) each route of the artifact, loaded here.
        routes = {r: load_serving(data, route=r) for r in ROUTES}
        plain = create_model("mnasnet1_0", dtype=torch.bfloat16, dw_impl="torch", seed=0)
        plain.load_state_dict(state)
        torch_route = make_predict_fn(plain)
        for fn_ in COUNTERS.values():
            fn_.launches = 0
        rows = []
        for b in SERVE_SIZES:
            xb = images[:b].contiguous()
            row = {"bs": b}
            eager, graph = routes["eager"](xb), routes["graph"](xb)
            if not torch.equal(graph, eager):
                raise RuntimeError(f"bs{b}: the graph route differs from eager")
            if b == BATCH and not torch.equal(eager, live):
                raise RuntimeError("the artifact's eager route differs from the live forward")
            if b in COMPILE_SIZES:
                t0 = time.perf_counter()
                comp = routes["compile"](xb)
                torch.cuda.synchronize()
                row["compile_first_call_s"] = time.perf_counter() - t0
                row["compile_vs_eager_max_abs_diff"] = float((comp - eager).abs().max())
                # The bars over all 128 images at every size: at bs b the
                # compiled call of each slice of b (a top-1 of one image
                # says little).
                comp = torch.cat([routes["compile"](images[i:i + b])
                                  for i in range(0, BATCH, b)])
                ref = torch_route(images)
                row["compile_max_abs_diff_vs_torch"] = float((comp - ref).abs().max())
                row["compile_tol"] = 0.25 * float(ref.abs().max())
                row["compile_top1_agreement"] = float(
                    (comp.argmax(-1) == ref.argmax(-1)).float().mean())
                if row["compile_max_abs_diff_vs_torch"] > row["compile_tol"] \
                        or row["compile_top1_agreement"] < 0.5:
                    raise RuntimeError(f"bs{b}: the compile route misses the bf16 bars: {row}")
            rows.append(row)
            log(f"[serve] {row}")
        torch.cuda.synchronize()
        launches = counts()
        counted = sum(routed_forwards(routes[r], {})["counted"] for r in ROUTES)
        if launches != _scaled(LAUNCHES_PER_VAL_FORWARD, counted):
            raise RuntimeError(f"routes' launches {launches}; expected {counted} counted "
                               f"forwards of {LAUNCHES_PER_VAL_FORWARD}")
        out["routes_launches"] = launches
        out["graph_replays"] = sum(routes["graph"].replays.values())
        out["by_size"] = rows
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out, {"routes": routes, "images": images}


def serve_timing(out: dict, held: dict, card: str) -> None:
    """ms per batch and images/s of each route of the serve phase's artifact
    at each size (CUDA events; eager and graph, and compile at
    ``COMPILE_SIZES``), the fastest, and the table of the fastest route that
    ``SERVE_ROUTE_BATCH_RANGES`` is set from, into ``out``."""
    routes, images, rows = held["routes"], held["images"], out["by_size"]
    for row in rows:
        b = row["bs"]
        xb = images[:b].contiguous()
        timed = ["eager", "graph"] + (["compile"] if b in COMPILE_SIZES else [])
        for r in timed:
            ms = time_ms(lambda: routes[r](xb), target_ms=300.0)
            row[f"{r}_ms"] = ms
            row[f"{r}_images_per_s"] = b / ms * 1e3
        row["fastest"] = min(timed, key=lambda r: row[f"{r}_ms"])
    measured = route_table(rows)
    out["route_table"] = measured
    out["route_table_matches_SERVE_ROUTE_BATCH_RANGES"] = measured == SERVE_ROUTE_BATCH_RANGES
    log(f"[serve] ms per batch by route on {card}:")
    for row in rows:
        log("[serve]   bs{:>4}: ".format(row["bs"]) + ", ".join(
            f"{r} {row[f'{r}_ms']:.3f} ms ({row[f'{r}_images_per_s']:.1f} images/s)"
            for r in ROUTES if f"{r}_ms" in row) + f"; fastest {row['fastest']}")
    log(f"[serve] measured table {measured}; SERVE_ROUTE_BATCH_RANGES "
        f"{SERVE_ROUTE_BATCH_RANGES}")


def serve_cache() -> dict:
    """The serve phase's (c), a background job (``FARM_JOBS``): the serving
    artifact of the serve phase's weights, its first compiled call at bs1 in
    two fresh processes with the same compilation cache, cold then warm."""
    _, state = serving_weights(torch.Generator(device="cuda").manual_seed(3))
    work = FARM_WORK / "serve_cache"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        fn, x = build_forward("mnasnet1_0", 1000, "bfloat16", state, IMAGE, BATCH,
                              device="cuda")
        art, cache = work / "model.pt2", work / "cache"
        art.write_bytes(export_artifact(fn, x, symbolic_batch=True))
        out = {k: _child(_CACHE_CHILD, [cache, art])["first_call_s"]
               for k in ("cold_first_call_s", "warm_first_call_s")}
        out["entries"] = sum(len(f) for _, _, f in os.walk(cache))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[serve] compilation cache: {out}")
    if not out["entries"]:
        raise RuntimeError("the compile left no entry in the compilation cache")
    return out


def profile_forward(fn, x, path: Path) -> dict:
    """Device time by kernel over 3 calls of ``fn(x)`` (torch.profiler),
    written as a table to ``path``; returns the kernel time per call, its
    share of the call's wall time, the device time and launches per call of
    each of the port's kernels, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    path.write_text(events.table(sort_by=key, row_limit=60))
    # Kernel rows only: the rows of aten ops repeat their kernels' time.
    kernels = sorted(((getattr(e, key) / 1e3 / 3, e.count // 3, e.key) for e in events
                      if getattr(e, "device_type", None) == DeviceType.CUDA), reverse=True)
    device_ms = sum(k[0] for k in kernels)
    port = {}
    for name, prefix in KERNEL_NAMES.items():
        mine = [(ms, n) for ms, n, key in kernels if prefix in key]
        if mine:
            port[name] = {"ms": sum(m for m, _ in mine), "launches": sum(n for _, n in mine)}
    return {"device_ms_per_call": device_ms, "wall_ms_per_call": wall_ms,
            "device_busy_share": device_ms / wall_ms, "port_kernels": port,
            "top_kernels": [{"ms": ms, "launches": n, "name": name[:90]}
                            for ms, n, name in kernels[:25]]}


def _native_bn_backward(g, x, gamma, mean, inv, mask):
    """One PyTorch call of the BN backward on the already-masked g (NCHW
    views of the NHWC tensors): the yardstick, used nowhere in the port."""
    return torch.ops.aten.native_batch_norm_backward(
        nchw(g), nchw(x), gamma, None, None, mean, inv, True, BN_EPS, mask)


def _moment_errors(x, mean, var) -> tuple[float, float]:
    """(mean's error in standard deviations, var's relative error), worst
    channel, against float64 moments of x."""
    x64 = x.double()
    m64, v64 = x64.mean(dim=(0, 1, 2)), x64.var(dim=(0, 1, 2), unbiased=False)
    return (float(((mean.double() - m64).abs() / v64.sqrt()).max()),
            float(((var.double() - v64).abs() / v64).max()))


def bn_forward_checks(x, y, vecs) -> dict:
    """The region's forward kernels at one shape: the stats kernel's sums
    against the plain version's, the moments from them against float64
    beside the plain fp32 path's, each within the plain path's error
    (floored at 2^-20), two launches bit-identical; the apply kernel bit for
    bit the plain forward's ``y`` (from the same mean and var), its ``y > 0``
    the backward's mask."""
    sums, sums2, ref = bn_fwd_stats(x), bn_fwd_stats(x), bn_fwd_stats_reference(x)
    y_k, y_k2 = bn_relu_apply(x, *vecs), bn_relu_apply(x, *vecs)
    bits = torch.int16 if y.element_size() == 2 else torch.int32
    row = {"stats_rel_err": rel_err(sums, ref),
           "stats_max_abs_err": float((sums - ref).abs().max()),
           "apply_max_abs_err": float((y_k.float() - y.float()).abs().max()),
           "apply_bitwise_plain": bool(torch.equal(y_k.view(bits), y.view(bits))),
           "apply_mask_matches": bool(torch.equal(y_k > 0, relu_mask_reference(x, *vecs))),
           "fwd_deterministic": bool(torch.equal(sums, sums2) and torch.equal(y_k, y_k2))}
    for stats in ("one_pass", "two_pass"):
        ours = _moment_errors(x, *region_moments(x, stats))
        plain = _moment_errors(x, *batch_moments(x, stats))
        row[f"{stats}_mean_err"], row[f"{stats}_var_err"] = ours
        row[f"{stats}_plain_mean_err"], row[f"{stats}_plain_var_err"] = plain
        row[f"{stats}_within_plain"] = all(e <= max(p, 2.0 ** -20) for e, p in zip(ours, plain))
    return row


def bn_phase(timing: bool) -> list[dict]:
    """The BN+ReLU region's kernels, forward and backward, at the 35 regions
    of the training forward."""
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for name, h, c in bn_region_shapes():
        gamma = torch.rand(c, device="cuda", generator=g) + 0.5
        beta = torch.rand(c, device="cuda", generator=g) - 0.5
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            x = (torch.randn(BATCH, h, h, c, device="cuda", generator=g) * 2 + 0.3).to(dt)
            dy = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(dt)
            y, mean, var = _fwd_math(x, gamma, beta, BN_EPS, "one_pass")
            inv = torch.rsqrt(var + BN_EPS)
            vecs = (mean, inv, gamma, beta)
            dg, db = bn_bwd_reduce(x, dy, *vecs)
            dx = bn_bwd_dx(x, dy, *vecs, dg, db)
            rdg, rdb = bn_bwd_reduce_reference(x, dy, *vecs)
            rdx = bn_bwd_dx_reference(x, dy, *vecs, rdg, rdb)
            dg2, db2 = bn_bwd_reduce(x, dy, *vecs)
            dx2 = bn_bwd_dx(x, dy, *vecs, dg2, db2)
            # With dy = 1, dβ counts each channel's unmasked elements.
            _, count = bn_bwd_reduce(x, torch.ones_like(dy), *vecs)
            positive = (y > 0).float().sum(dim=(0, 1, 2))
            torch.cuda.synchronize()
            row = {"region": name, "shape": f"{h}x{h}x{c}", "dtype": dname,
                   "dgamma_rel_err": rel_err(dg, rdg), "dbeta_rel_err": rel_err(db, rdb),
                   "dx_rel_err": rel_err(dx, rdx),
                   "reduce_max_abs_err": float(torch.maximum((dg - rdg).abs().max(),
                                                             (db - rdb).abs().max())),
                   "dx_max_abs_err": float((dx.float() - rdx.float()).abs().max()),
                   "mask_count_exact": bool(torch.equal(count, positive)),
                   "mask_matches_plain": bool(torch.equal(
                       relu_mask_reference(x, *vecs), y > 0)),
                   "deterministic": bool(torch.equal(dg, dg2) and torch.equal(db, db2)
                                         and torch.equal(dx, dx2)),
                   **bn_forward_checks(x, y, vecs)}
            bad = [k for k in ("dgamma_rel_err", "dbeta_rel_err") if row[k] > TOL_BN_SUMS[dname]]
            if row["dx_rel_err"] > TOL_BN_DX[dname]:
                bad.append("dx_rel_err")
            if row["stats_rel_err"] > TOL_BN_SUMS[dname]:
                bad.append("stats_rel_err")
            bad += [k for k in ("mask_count_exact", "mask_matches_plain", "deterministic",
                                "apply_bitwise_plain", "apply_mask_matches",
                                "fwd_deterministic", "one_pass_within_plain",
                                "two_pass_within_plain")
                    if not row[k]]
            if bad or not torch.isfinite(dx).all():
                raise RuntimeError(f"bn {name} {dname}: {bad}: {row}")
            plane = x.numel() * x.element_size()
            row["reduce_bound_ms"], row["reduce_bound_by"] = bound(
                2 * plane + 6 * c * 4, 8 * x.numel(), "float32")
            row["dx_bound_ms"], row["dx_bound_by"] = bound(
                3 * plane + 6 * c * 4, 10 * x.numel(), "float32")
            # The forward's: the stats read x and write the (2, C) sums; the
            # apply reads x and the four vectors and writes y.
            row["stats_bound_ms"], row["stats_bound_by"] = bound(
                plane + 2 * c * 4, 3 * x.numel(), "float32")
            row["apply_bound_ms"], row["apply_bound_by"] = bound(
                2 * plane + 4 * c * 4, 6 * x.numel(), "float32")
            row["reduce_plan"] = reduce_plan(x.numel() // c, c, x.element_size())._asdict()
            row["stats_plan"] = stats_plan(x.numel() // c, c, x.element_size())._asdict()
            row["apply_plan"] = apply_plan(x.numel() // c, c, x.element_size())._asdict()
            if timing and dt == torch.bfloat16:
                def stats_once():
                    return bn_fwd_stats(x)

                def apply_once():
                    return bn_relu_apply(x, *vecs)

                # The forward's kernels, as the backward's below; the plain
                # versions (the moments, the two-op apply) and the region's
                # whole plain forward (_fwd_math) beside them.
                for kind, once in (("stats", stats_once), ("apply", apply_once)):
                    row[f"{kind}_ms"] = time_ms(once, 30.0)
                    row[f"{kind}_host_ms"] = host_ms(once)
                    row[f"{kind}_device_ms"] = time_ms(once, 30.0, graph=True)
                row["stats_plain_ms"] = time_ms(lambda: batch_moments(x, "one_pass"), 30.0)
                row["apply_plain_ms"] = time_ms(
                    lambda: bn_relu_apply_reference(x, *vecs), 30.0)
                row["fwd_plain_ms"] = time_ms(
                    lambda: _fwd_math(x, gamma, beta, BN_EPS, "one_pass"), 30.0)
                row["fwd_plain_device_ms"] = time_ms(
                    lambda: _fwd_math(x, gamma, beta, BN_EPS, "one_pass"), 30.0, graph=True)
                row["fwd_region_device_ms"] = time_ms(
                    lambda: _fwd_region(x, gamma, beta, BN_EPS, "one_pass"), 30.0, graph=True)
                def reduce_once():
                    return bn_bwd_reduce(x, dy, *vecs)

                def dx_once():
                    return bn_bwd_dx(x, dy, *vecs, dg, db)

                # Eager through the counted wrappers (the yardstick), the
                # wrappers' host time per call, and device time from CUDA-graph
                # replays of one call.
                row["reduce_ms"] = time_ms(reduce_once, 30.0)
                row["dx_ms"] = time_ms(dx_once, 30.0)
                row["reduce_host_ms"] = host_ms(reduce_once)
                row["dx_host_ms"] = host_ms(dx_once)
                row["reduce_device_ms"] = time_ms(reduce_once, 30.0, graph=True)
                row["dx_device_ms"] = time_ms(dx_once, 30.0, graph=True)
                row["reduce_plain_ms"] = time_ms(lambda: bn_bwd_reduce_reference(x, dy, *vecs), 30.0)
                row["dx_plain_ms"] = time_ms(
                    lambda: bn_bwd_dx_reference(x, dy, *vecs, rdg, rdb), 30.0)
                gm = (dy * (y > 0)).contiguous()
                try:
                    for kind, mask in (("reduce", [False, True, True]), ("dx", [True, False, False])):
                        def library(mask=mask):
                            return _native_bn_backward(gm, x, gamma, mean, inv, mask)

                        row[f"{kind}_library_ms"] = time_ms(library, 30.0)
                        row[f"{kind}_library_device_ms"] = time_ms(library, 30.0, graph=True)
                except RuntimeError as e:
                    row["library_refused"] = str(e).splitlines()[0]
                # The torch route: autograd of relu(BN(x)) with batch statistics.
                xr = x.detach().requires_grad_()
                gr, br = gamma.detach().requires_grad_(), beta.detach().requires_grad_()
                yr = _fwd_math(xr, gr, br, BN_EPS, "one_pass")[0]
                row["torch_route_ms"] = time_ms(lambda: torch.autograd.grad(
                    yr, (xr, gr, br), dy, retain_graph=True), 30.0)
                del xr, yr, gm
            log(f"[bn] {row}")
            rows.append(row)
            del x, dy, y, dx, rdx, dx2
    return rows


def dw_train_phase() -> list[dict]:
    """The depthwise autograd Function (kernel forward, torch-op backward)
    against the torch route's autograd at one stride-1 and one stride-2 shape."""
    g = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for h, c, k, s in ((IMAGE // 2, 32, 3, 1), (IMAGE // 2, 48, 3, 2)):
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            x = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(dt)
            w = torch.randn(k, k, 1, c, device="cuda", generator=g) * 0.3
            cot = torch.randn(BATCH, out_size(h, k, s), out_size(h, k, s), c, device="cuda",
                              generator=g).to(dt)
            grads = []
            for route in ("kernel", "torch"):
                xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
                fn = (lambda a, b: depthwise_conv_train(a, b, stride=s)) if route == "kernel" \
                    else (lambda a, b: depthwise_conv2d(a, b, stride=s, impl="torch"))
                grads.append(torch.autograd.grad(fn(xr, wr), (xr, wr), cot))
            (dx, dw), (tdx, tdw) = grads
            torch.cuda.synchronize()
            row = {"shape": f"{h}x{h}x{c} k{k} s{s}", "dtype": dname,
                   "dx_rel_err": rel_err(dx, tdx), "dw_rel_err": rel_err(dw, tdw),
                   "tol": TOL_DW_TRAIN[dname]}
            log(f"[dw-train] {row}")
            if (row["dx_rel_err"] > row["tol"][0] or row["dw_rel_err"] > row["tol"][1]
                    or dx.dtype != dt or dw.dtype != torch.float32):
                raise RuntimeError(f"dw training op {row['shape']} {dname} disagrees: {row}")
            rows.append(row)
    return rows


def b4_shapes(size: int = B4_IMAGE) -> tuple[list, list]:
    """(name, H, C) of the 64 BN+SiLU regions of efficientnet_b4's training
    forward at ``size`` px (the stem, each block's expand BN where it has
    one and its dw BN, the head) and (name, H, C, k, stride) of its 32 dw
    convs, H the conv's input plane."""
    from mnasnet_tpu_torch.models.efficientnet import B0_STEM, VARIANTS, stage_table
    from mnasnet_tpu_torch.models.mnasnet import round_to_multiple_of

    width, depth = VARIANTS["efficientnet_b4"][:2]
    h = out_size(size, 3, 2)
    regions, dws = [("stem", h, round_to_multiple_of(B0_STEM * width, 8))], []
    table = stage_table(width, depth)
    for i, (e, k, s, cin, cout, repeats) in enumerate(table):
        for j in range(repeats):
            ci, st = (cin, s) if j == 0 else (cout, 1)
            mid = round_to_multiple_of(ci * e, 8)
            if e != 1:
                regions.append((f"s{i + 1}b{j}.expand", h, mid))
            dws.append((f"s{i + 1}b{j}", h, mid, k, st))
            h = out_size(h, k, st)
            regions.append((f"s{i + 1}b{j}.dw", h, mid))
    return regions + [("head", h, 4 * table[-1][4])], dws


def _b4_region_row(h, c, dt, g, timing) -> dict:
    """The SiLU apply, reduce and dx kernels at one region shape of
    efficientnet_b4 (batch B4_BATCH) against their plain versions on the
    same tensors; beside each error, the ReLU version's distance from the
    SiLU one (what a kernel of the wrong activation would read)."""
    dname = str(dt).split(".")[1]
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    beta = torch.rand(c, device="cuda", generator=g) - 0.5
    x = (torch.randn(B4_BATCH, h, h, c, device="cuda", generator=g) * 2 + 0.3).to(dt)
    dy = torch.randn(B4_BATCH, h, h, c, device="cuda", generator=g).to(dt)
    mean, var = batch_moments(x, "one_pass")
    vecs = (mean, torch.rsqrt(var + B4_BN_EPS), gamma, beta)
    ops = (bn_relu_apply, bn_bwd_reduce, bn_bwd_dx)
    before = [dict(op.launches_by_act) for op in ops]
    y = bn_relu_apply(x, *vecs, act="silu")
    dg, db = bn_bwd_reduce(x, dy, *vecs, act="silu")
    dx = bn_bwd_dx(x, dy, *vecs, dg, db, act="silu")
    dg2, db2 = bn_bwd_reduce(x, dy, *vecs, act="silu")
    dx2 = bn_bwd_dx(x, dy, *vecs, dg2, db2, act="silu")
    torch.cuda.synchronize()
    counted = [(op.launches_by_act["silu"] - b["silu"], op.launches_by_act["relu"] - b["relu"])
               for op, b in zip(ops, before)]
    ry = bn_relu_apply_reference(x, *vecs, act="silu")
    rdg, rdb = bn_bwd_reduce_reference(x, dy, *vecs, act="silu")
    rdx = bn_bwd_dx_reference(x, dy, *vecs, rdg, rdb, act="silu")
    relu_y = bn_relu_apply_reference(x, *vecs, act="relu")
    relu_dg, relu_db = bn_bwd_reduce_reference(x, dy, *vecs, act="relu")
    relu_dx = bn_bwd_dx_reference(x, dy, *vecs, relu_dg, relu_db, act="relu")
    row = {"shape": f"{h}x{h}x{c}", "dtype": dname,
           "apply_rel_err": rel_err(y, ry), "dgamma_rel_err": rel_err(dg, rdg),
           "dbeta_rel_err": rel_err(db, rdb), "dx_rel_err": rel_err(dx, rdx),
           "apply_max_abs_err": float((y.float() - ry.float()).abs().max()),
           "reduce_max_abs_err": float(torch.maximum((dg - rdg).abs().max(),
                                                     (db - rdb).abs().max())),
           "dx_max_abs_err": float((dx.float() - rdx.float()).abs().max()),
           "relu_apply_rel_err": rel_err(relu_y, ry), "relu_dgamma_rel_err": rel_err(relu_dg, rdg),
           "relu_dx_rel_err": rel_err(relu_dx, rdx),
           "launches_silu_relu": counted,
           "deterministic": bool(torch.equal(dg, dg2) and torch.equal(db, db2)
                                 and torch.equal(dx, dx2))}
    tols = {"apply_rel_err": TOL_SILU_APPLY[dname], "dgamma_rel_err": TOL_BN_SUMS[dname],
            "dbeta_rel_err": TOL_BN_SUMS[dname], "dx_rel_err": TOL_BN_DX[dname]}
    bad = [k for k, tol in tols.items() if row[k] > tol]
    # The bars tell the activations apart: a kernel of the wrong activation
    # (the ReLU versions here) fails each of them.
    bad += [k for k, tol in (("relu_apply_rel_err", tols["apply_rel_err"]),
                             ("relu_dgamma_rel_err", tols["dgamma_rel_err"]),
                             ("relu_dx_rel_err", tols["dx_rel_err"])) if row[k] <= tol]
    if counted != [(2 if op is not bn_relu_apply else 1, 0) for op in ops]:
        bad.append("launches_silu_relu")
    if not row["deterministic"]:
        bad.append("deterministic")
    if bad or not torch.isfinite(dx).all() or dx.dtype != dt or y.dtype != dt:
        raise RuntimeError(f"b4 region {row['shape']} {dname}: {bad}: {row}")
    plane = x.numel() * x.element_size()
    row["stats_bound_ms"], _ = bound(plane + 2 * c * 4, 3 * x.numel(), "float32")
    row["apply_bound_ms"], _ = bound(2 * plane + 4 * c * 4, 6 * x.numel(), "float32")
    row["reduce_bound_ms"], _ = bound(2 * plane + 6 * c * 4, 8 * x.numel(), "float32")
    row["dx_bound_ms"], _ = bound(3 * plane + 6 * c * 4, 10 * x.numel(), "float32")
    if timing and dt == torch.bfloat16:
        once = {"stats": lambda: bn_fwd_stats(x),
                "apply": lambda: bn_relu_apply(x, *vecs, act="silu"),
                "reduce": lambda: bn_bwd_reduce(x, dy, *vecs, act="silu"),
                "dx": lambda: bn_bwd_dx(x, dy, *vecs, dg, db, act="silu")}
        for kind, fn in once.items():
            row[f"{kind}_ms"] = time_ms(fn, 30.0)
            row[f"{kind}_device_ms"] = time_ms(fn, 30.0, graph=True)
        row["apply_plain_ms"] = time_ms(
            lambda: bn_relu_apply_reference(x, *vecs, act="silu"), 30.0)
    return row


def _b4_dw_row(h, c, k, s, dt, g, timing) -> dict:
    """The dw kernel's SiLU epilogue (EfficientNet's eval forward) at one
    of efficientnet_b4's dw shapes (batch B4_BATCH) against its plain
    version, beside the ReLU epilogue's distance from it."""
    dname = str(dt).split(".")[1]
    x = torch.randn(B4_BATCH, h, h, c, device="cuda", generator=g).to(dt)
    w = torch.randn(k, k, 1, c, device="cuda", generator=g) * 0.3
    scale = torch.rand(c, device="cuda", generator=g) + 0.5
    bias = torch.randn(c, device="cuda", generator=g) * 0.1
    before = dw_conv_bn_act.launches
    y = dw_conv_bn_act(x, w, scale, bias, stride=s, relu=False, silu=True)
    torch.cuda.synchronize()
    ref = dw_conv_reference(x, w, scale, bias, stride=s, relu=False, silu=True)
    # An epilogue of the wrong activation (ReLU, or none) fails the bar.
    relu = dw_conv_reference(x, w, scale, bias, stride=s, relu=True)
    linear = dw_conv_reference(x, w, scale, bias, stride=s, relu=False)
    row = {"shape": f"{h}x{h}x{c} k{k} s{s}", "dtype": dname, "rel_err": rel_err(y, ref),
           "max_abs_err": float((y.float() - ref.float()).abs().max()),
           "relu_rel_err": rel_err(relu, ref), "linear_rel_err": rel_err(linear, ref),
           "tol": TOL_DW[dname], "launches": dw_conv_bn_act.launches - before}
    if (row["rel_err"] > TOL_DW[dname]
            or min(row["relu_rel_err"], row["linear_rel_err"]) <= TOL_DW[dname]
            or row["launches"] != 1 or y.dtype != dt or not torch.isfinite(y).all()):
        raise RuntimeError(f"b4 dw SiLU epilogue {row['shape']} {dname}: {row}")
    ho = out_size(h, k, s)
    row["bound_ms"], row["bound_by"] = bound(
        (x.numel() + B4_BATCH * ho * ho * c) * x.element_size() + (k * k + 2) * c * 4,
        2 * k * k * B4_BATCH * ho * ho * c, dname)
    if timing and dt == torch.bfloat16:
        fn = lambda: dw_conv_bn_act(x, w, scale, bias, stride=s, relu=False, silu=True)  # noqa: E731
        row["ms"] = time_ms(fn, 30.0)
        row["device_ms"] = time_ms(fn, 30.0, graph=True)
        row["plain_ms"] = time_ms(
            lambda: dw_conv_reference(x, w, scale, bias, stride=s, relu=False, silu=True), 30.0)
    return row


def _summed(rows: list, counts: dict, keys) -> dict:
    """Each key of the bf16 rows summed over the step's regions or convs:
    a shape's row counted as often as the step runs that shape."""
    bf = {r["shape"]: r for r in rows if r["dtype"] == "bfloat16"}
    return {k: sum(bf[s][k] * n for s, n in counts.items()) if all(
        k in r for r in bf.values()) else None for k in keys}


def b4_phase(timing: bool) -> dict:
    """efficientnet_b4's kernels on its own shapes: the SiLU apply, reduce
    and dx at each distinct BN+SiLU region shape and the dw SiLU epilogue
    at each distinct dw shape (380 px, batch 64, bf16 and fp32) against
    their plain versions, timed beside their bounds and summed over a
    step; then one counted train step on the default train route with the
    counters zeroed just before it."""
    g = torch.Generator(device="cuda").manual_seed(19)
    regions, dws = b4_shapes()
    region_counts, dw_counts = {}, {}
    for _, h, c in regions:
        region_counts[f"{h}x{h}x{c}"] = region_counts.get(f"{h}x{h}x{c}", 0) + 1
    for _, h, c, k, s in dws:
        key = f"{h}x{h}x{c} k{k} s{s}"
        dw_counts[key] = dw_counts.get(key, 0) + 1
    region_rows, dw_rows = [], []
    for shape in region_counts:
        h, _, c = (int(v) for v in shape.split("x"))
        for dt in (torch.bfloat16, torch.float32):
            row = _b4_region_row(h, c, dt, g, timing)
            log(f"[b4] region {row}")
            region_rows.append(row)
    for h, c, k, s in dict.fromkeys((h, c, k, s) for _, h, c, k, s in dws):
        for dt in (torch.bfloat16, torch.float32):
            row = _b4_dw_row(h, c, k, s, dt, g, timing)
            log(f"[b4] dw {row}")
            dw_rows.append(row)
    torch.cuda.empty_cache()
    kinds = ("stats", "apply", "reduce", "dx")
    out = {"regions": len(regions), "dws": len(dws), "region_rows": region_rows,
           "dw_rows": dw_rows,
           "region_step": _summed(region_rows, region_counts,
                                  [f"{k}_{w}" for k in kinds for w in ("ms", "device_ms",
                                                                       "bound_ms")]
                                  + ["apply_plain_ms"]),
           "dw_step": _summed(dw_rows, dw_counts, ("ms", "device_ms", "bound_ms", "plain_ms"))}

    # One counted step of the production train step, counters zeroed just
    # before it and read just after.
    model = create_model("efficientnet_b4", device="cuda", num_classes=1000,
                         dtype=torch.bfloat16, bn_ema="external", stem_s2d=True, seed=19)
    tx = create_optimizer("rmsprop", 1e-4, fused="small")
    state = TrainState.create(model, tx, seed=20)
    step = make_train_step(model, tx, 0.1)
    images = torch.randn(B4_BATCH, B4_IMAGE, B4_IMAGE, 3, device="cuda", generator=g)
    labels = torch.randint(0, 1000, (B4_BATCH,), device="cuda", generator=g)
    ops = (bn_relu_apply, bn_bwd_reduce, bn_bwd_dx)
    for fn in (bn_fwd_stats, dw_conv_bn_act, mbconv_fused, *ops):
        fn.launches = 0
    for op in ops:
        for act in op.launches_by_act:
            op.launches_by_act[act] = 0
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, images, labels)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    counted = step.counted()
    launches = {"dw_conv_bn_act": dw_conv_bn_act.launches, "mbconv_block": mbconv_fused.launches,
                "bn_fwd_stats": bn_fwd_stats.launches,
                **{f"{op.__name__}.{act}": op.launches_by_act[act]
                   for act in ("silu", "relu") for op in ops}}
    losses = [float(v) for v in losses]
    out["train"] = {"route": step.route, "counted_steps": counted, "launches": launches,
                    "losses": losses, "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"[b4] {TRAIN_STEPS} steps on the {step.route} route: {out['train']}")
    if step.route != TRAIN_ROUTE or counted < 1:
        raise RuntimeError(f"expected counted steps on the {TRAIN_ROUTE} route: {out['train']}")
    if launches != _scaled(B4_LAUNCHES_PER_STEP, counted):
        raise RuntimeError(f"expected {B4_LAUNCHES_PER_STEP} launches per counted step, "
                           f"got {launches} over {counted}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"b4 losses not finite: {losses}")
    del model, state, step, images
    torch.cuda.empty_cache()
    return out


def b4_kernel_entries(b4: dict) -> list[dict]:
    """The kernels line's entries of efficientnet_b4's kernels: each SiLU
    kernel and the dw SiLU epilogue summed over one step's launches (bf16,
    batch 64, 380 px) beside its bound, its largest error over both dtypes."""
    reg, rows = b4["region_step"], b4["region_rows"]
    where = f"{b4['regions']} regions of one efficientnet_b4 step at 380 px, batch 64, bf16"

    def entry(name, kind, err):
        return {"name": name, "route": "cuda", "source": "mnasnet_tpu_torch/csrc/bn_bwd.cu",
                "launches_per_step": b4["regions"],
                "max_abs_err": max(r[err] for r in rows),
                "ms": reg[f"{kind}_ms"], "device_ms": reg[f"{kind}_device_ms"],
                "bound_ms": reg[f"{kind}_bound_ms"], "summed_over": where}

    out = [entry("bn_fwd_stats.b4", "stats", "apply_max_abs_err"),
           entry("bn_silu_apply", "apply", "apply_max_abs_err"),
           entry("bn_silu_bwd_reduce", "reduce", "reduce_max_abs_err"),
           entry("bn_silu_bwd_dx", "dx", "dx_max_abs_err")]
    # The stats kernel is held to its plain version by the bn phase; its
    # entry here carries the times only.
    out[0].pop("max_abs_err")
    out[1]["plain_ms"] = reg["apply_plain_ms"]
    out.append({"name": "dw_conv_bn_act.silu", "route": "cuda",
                "source": "mnasnet_tpu_torch/csrc/dw_conv.cu", "launches_per_step": b4["dws"],
                "max_abs_err": max(r["max_abs_err"] for r in b4["dw_rows"]),
                **b4["dw_step"],
                "summed_over": f"{b4['dws']} dw convs of one efficientnet_b4 eval forward "
                               "at 380 px, batch 64, bf16"})
    return out


def train_batch():
    """The train phase's batch: 128x224x224x3 images and labels, seeded on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, device="cuda", generator=g)
    labels = torch.randint(0, 1000, (BATCH,), device="cuda", generator=g)
    return images, labels


def _train_setup(dtype, route, seed=0, step_route=None, schedule=False, model_ema=None,
                 replicas=None, **model_kw):
    """The production configuration (``route``: the model's kernel route,
    "auto" = its default) and its train step on ``step_route`` (None: the
    default train route), sync-BN over ``replicas`` when given. ``schedule``:
    warmup-cosine from 0 over the ``TRAIN_STEPS`` steps, a rate that changes
    every step."""
    kw = {} if route == "auto" else {"dw_impl": route, "bn_bwd": route}
    model = create_model("mnasnet1_0", dtype=dtype, bn_ema="external", stem_s2d=True,
                         seed=seed, **kw, **model_kw)
    lr = make_schedule("cosine", TRAIN_LR, TRAIN_STEPS, 2, warmup_epochs=1) if schedule \
        else TRAIN_LR
    tx = create_optimizer("rmsprop", lr, fused="small", model_ema=model_ema)
    state = TrainState.create(model, tx, seed=seed)
    set_replicas(model, replicas)
    return model, state, make_train_step(model, tx, label_smoothing=0.1, route=step_route,
                                         replicas=replicas)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _stats(model):
    return {n: b.clone() for n, b in model.named_buffers() if n.endswith(("mean", "var"))}


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (cuBLAS's fixed workspace is set from the
    first call of this process on): what bitwise comparisons of steps need."""
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(previous)


def _snapshot(model, step, state) -> dict:
    return {"model": {k: v.clone() for k, v in model.state_dict().items()},
            "tx": step._steps.tx.state_dict(), "generator": state.generator.get_state(),
            "step": state.step}


def _route_runs(images, labels) -> dict:
    """Bitwise: 5 steps on the graph route against 5 eager steps, and eager,
    graph, eager on one state (steps 1-2, 3-4, 5) against all-eager, with
    dropout, a rate that changes every step and the model EMA with warmup,
    under deterministic algorithms."""
    runs = {}
    for name, routes in (("eager", ["eager"] * TRAIN_STEPS), ("graph", ["graph"] * TRAIN_STEPS),
                         ("mixed", ["eager", "eager", "graph", "graph", "eager"])):
        model, state, first = _train_setup(torch.bfloat16, "auto", seed=2, step_route="eager",
                                           schedule=True, model_ema=0.999)
        tx = first._steps.tx
        steps = {r: make_train_step(model, tx, 0.1, route=r) for r in set(routes)}
        losses, lrs = [], []
        with deterministic():
            for r in routes:
                state, metrics = steps[r](state, images, labels)
                losses.append(metrics["loss"])
                lrs.append(tx.inner.lr.clone())
        torch.cuda.synchronize()
        runs[name] = {"losses": [float(v) for v in losses], "lrs": [float(v) for v in lrs],
                      **_snapshot(model, steps[routes[0]], state),
                      "replays": sum(sum(st.replays.values()) for st in steps.values())}
        del model, state, steps, tx, first
    ref = runs["eager"]
    out = {"lrs": ref["lrs"], "losses": ref["losses"]}
    for name in ("graph", "mixed"):
        run = runs[name]
        same = {"losses": run["losses"] == ref["losses"],
                **{k: _tree_equal(run[k], ref[k]) for k in ("model", "tx", "generator")}}
        out[f"{name}_vs_eager_bitwise"] = same
        out[f"{name}_replays"] = run["replays"]
        log(f"[train] {name} route vs eager over {TRAIN_STEPS} steps, bitwise: {same}")
        if not all(same.values()):
            raise RuntimeError(f"the {name} run differs from the eager one: {same}")
    if len(set(out["lrs"])) != TRAIN_STEPS or runs["graph"]["replays"] != TRAIN_STEPS - 1:
        raise RuntimeError(f"rates {out['lrs']} or replays {runs['graph']['replays']}")
    return out


def one_ulp(images):
    """The images moved by one bf16 ulp, each up or down (seeded)."""
    return images * (1 + 2.0 ** -7 * torch.randint(
        0, 2, images.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(6)).float().mul(2).sub(1))


def _first_step(step_route, images, labels, route="kernel", keep=False, **model_kw) -> dict:
    """The first bf16 step of the production configuration from seed 0 on
    ``step_route``: the loss, the parameters before and after, the BN
    statistics and the seconds it took (a compile included); with ``keep``
    the model, state and step under "kept"."""
    m, st, stp = _train_setup(torch.bfloat16, route, step_route=step_route, **model_kw)
    p0 = _params(m)
    t0 = time.perf_counter()
    st, met = stp(st, images, labels)
    torch.cuda.synchronize()
    out = {"loss": float(met["loss"]), "p0": p0, "params": _params(m), "stats": _stats(m),
           "s": time.perf_counter() - t0}
    if keep:
        out["kept"] = (m, st, stp)
    return out


def compile_first_step(remat: bool) -> dict:
    """The first bf16 step of the compile route (Inductor), compiled once,
    against the eager step from the same weights, beside the eager step on
    images moved by one bf16 ulp (``_held_to_one_ulp``); with ``remat`` as
    the knobs phase sets it. A background job (``FARM_JOBS``); without
    ``remat`` it then waits for :func:`farm_go` and, when told to, times
    the compiled step as :func:`train_timing` times the other routes."""
    images, labels = train_batch()
    kw = {"remat": True} if remat else {}
    first = {"eager": _first_step("eager", images, labels, **kw),
             "eager_one_ulp": _first_step("eager", one_ulp(images), labels, **kw)}
    base = memory_base(torch.device("cuda"))
    first["compile"] = _first_step("compile", images, labels, keep=not remat, **kw)
    kept = first["compile"].pop("kept", None)
    what = "the compile route" + (" with remat" if remat else "")
    comp = _held_to_one_ulp(first["compile"], first["eager"], first["eager_one_ulp"],
                            f"{what} against eager")
    comp["first_call_s"] = first["compile"]["s"]
    log(f"[{'knobs' if remat else 'train'}] bf16 first step, {what} vs eager: "
        f"{json.dumps(comp)}")
    del first
    if kept is not None and _farm_wait_go("train_compile"):
        m, st, stp = kept
        stp(st, images, labels)
        torch.cuda.synchronize()
        row = {"first_call_s": comp["first_call_s"],
               "peak_memory_gb": (torch.cuda.max_memory_allocated() - base[0]) / 1e9,
               "reserved_memory_gb": (torch.cuda.memory_reserved() - base[1]) / 1e9,
               "ms_per_step": time_ms(lambda: stp(st, images, labels), target_ms=2000.0)}
        row["images_per_s"] = BATCH / row["ms_per_step"] * 1e3
        row["host_ms_per_step"] = host_ms(lambda: stp(st, images, labels), iters=5)
        comp["timing"] = row
        log(f"[train] bs{BATCH} bf16 kernel_compile: {row['ms_per_step']:.3f} ms/step, "
            f"{row['images_per_s']:.1f} images/s, peak {row['peak_memory_gb']:.2f} GB, "
            f"first call {row['first_call_s']:.1f} s (beside the other jobs)")
    return comp


def _held_to_one_ulp(ours: dict, ref: dict, moved: dict, what: str) -> dict:
    """``ours`` against the first step ``ref``, within the bf16 bars of the
    compile route: loss and BN moments within 1e-5 or 4 times ``ref``'s own
    move when its images change by one bf16 ulp (``moved``), the update
    within 1e-2 relative RMS or 4 times that move; raises outside them."""
    comp = _vs_one_process(ours, ref, moved)
    own = _vs_one_process(moved, ref, moved)
    comp.update(one_ulp_loss_rel_diff=own["loss_rel_diff"],
                one_ulp_moments_max_diff=own["moments_max_diff"])
    bars = {"loss_rel_diff": max(1e-5, 4 * own["loss_rel_diff"]),
            "moments_max_diff": max(1e-5, 4 * own["moments_max_diff"]),
            "update_rel_rms_diff": max(1e-2, 4 * comp["one_ulp_update_rel_rms_diff"])}
    comp["bars"] = bars
    if any(comp[k] > bar for k, bar in bars.items()):
        raise RuntimeError(f"{what} disagrees: {comp}")
    return comp


def train_phase() -> dict:
    """The train phase's checks (8 in the module's docstring); the compile
    route's first step is the background job ``train_compile`` and the
    timing :func:`train_timing`."""
    images, labels = train_batch()
    model, state, step = _train_setup(torch.bfloat16, "auto")

    # The main path, on the default train route: counts set to 0 just
    # before, read just after.
    for fn in COUNTERS.values():
        fn.launches = 0
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, images, labels)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    losses = [float(v) for v in losses]
    counted = step.counted()
    out = {"route": step.route, "launches": launches, "losses": losses,
           "calls": sum(step.calls.values()), "replays": sum(step.replays.values()),
           "counted_steps": counted}
    log(f"[train] {TRAIN_STEPS} steps on the {step.route} route, losses {losses}, launches "
        f"{launches}, calls {out['calls']}, replays {out['replays']}")
    if step.route != TRAIN_ROUTE or out["calls"] != TRAIN_STEPS:
        raise RuntimeError(f"expected {TRAIN_STEPS} calls on the {TRAIN_ROUTE} route: {out}")
    if launches != _scaled(LAUNCHES_PER_STEP, counted):
        raise RuntimeError(f"expected {LAUNCHES_PER_STEP} launches per counted step "
                           f"({counted}), got {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite or not falling: {losses}")
    if model.training or state.step != TRAIN_STEPS:
        raise RuntimeError("the step left the model in train mode or miscounted steps")
    out["launches_per_step"] = LAUNCHES_PER_STEP

    out["routes_bitwise"] = _route_runs(images, labels)

    # One fp32 step from the same weights (TF32 is off): the kernel route
    # against the torch route, both eager.
    after = {}
    for route in ("kernel", "torch"):
        m32, st32, step32 = _train_setup(torch.float32, route, seed=1, step_route="eager")
        p0 = _params(m32)
        st32, met = step32(st32, images, labels)
        after[route] = {"loss": float(met["loss"]), "p0": p0, "params": _params(m32),
                        "stats": _stats(m32)}
        del m32, st32, step32
    ka, tb = after["kernel"], after["torch"]
    pk, pt = ka["params"], tb["params"]
    fp32 = {"loss_kernel": ka["loss"], "loss_torch": tb["loss"],
            "loss_rel_diff": abs(ka["loss"] - tb["loss"]) / abs(tb["loss"]),
            "update_rel_rms_diff": _update_rel_rms(ka, tb),
            "param_max_abs_diff": max(float((pk[n] - pt[n]).abs().max()) for n in pt),
            "params_outside_rtol5e-3_atol1e-4": sum(
                int((~torch.isclose(pk[n], pt[n], rtol=5e-3, atol=1e-4)).sum()) for n in pt),
            "param_count": sum(p.numel() for p in pt.values()),
            # The BN statistics as the data-parallel phase holds them: the
            # two routes sum the moments in different orders, and a mean near
            # 0 has no relative error to speak of.
            "moments_max_diff": _moments_diff(ka["stats"], tb["stats"])}
    out["fp32_kernel_vs_torch"] = fp32
    log(f"[train] fp32 one step, kernel route vs torch route: {json.dumps(fp32)}")
    if fp32["loss_rel_diff"] > 1e-5 or fp32["moments_max_diff"] > 1e-5 \
            or fp32["update_rel_rms_diff"] > 1e-2:
        raise RuntimeError(f"fp32 kernel route disagrees with the torch route: {fp32}")
    del after, ka, tb, pk, pt
    return out


def train_timing(card: str, profile_dir: Path | None, compiled: dict) -> dict:
    """Per train route (eager and graph on the kernel route, the torch route
    eager) in bf16 on the train phase's batch: ms per step, images/s, peak
    memory and the first call's seconds, and the fastest route with the
    compile route's row (``compiled``, timed in its job); with
    ``--profile`` each route's device time, busy share and kernels per
    counted launch (not the compile route's). Every route is timed first,
    then profiled: the profiler leaves the process slower after it."""
    images, labels = train_batch()
    out = {"by_route": {"kernel_compile": compiled}}
    runs = {}
    for route, step_route in (("kernel", "eager"), ("kernel", "graph"), ("torch", "eager")):
        name = f"{route}_{step_route}"
        base = memory_base(torch.device("cuda"))
        m, st, stp = _train_setup(torch.bfloat16, route, step_route=step_route)
        t0 = time.perf_counter()
        stp(st, images, labels)
        torch.cuda.synchronize()
        row = {"first_call_s": time.perf_counter() - t0}
        stp(st, images, labels)
        torch.cuda.synchronize()
        # What the route holds and takes at most over its first two calls,
        # beyond what was allocated before its model was made (a graph's
        # replays allocate nothing: its pool is reserved).
        row["peak_memory_gb"] = (torch.cuda.max_memory_allocated() - base[0]) / 1e9
        row["reserved_memory_gb"] = (torch.cuda.memory_reserved() - base[1]) / 1e9
        row["ms_per_step"] = time_ms(lambda: stp(st, images, labels), target_ms=2000.0)
        row["images_per_s"] = BATCH / row["ms_per_step"] * 1e3
        row["host_ms_per_step"] = host_ms(lambda: stp(st, images, labels), iters=5)
        out["by_route"][name] = row
        runs[name] = (m, st, stp)
        log(f"[train] bs{BATCH} bf16 {name}: {row['ms_per_step']:.3f} ms/step, "
            f"{row['images_per_s']:.1f} images/s, peak {row['peak_memory_gb']:.2f} GB, "
            f"first call {row['first_call_s']:.1f} s on {card}")
    for name, (m, st, stp) in runs.items():
        if profile_dir is None:
            break
        prof = profile_forward(lambda x: stp(st, x, labels), images,
                               profile_dir / f"profile_train_{name}.txt")
        out["by_route"][name]["profile"] = prof
        log(f"[train] {name} profile: device {prof['device_ms_per_call']:.3f} ms of "
            f"{prof['wall_ms_per_call']:.3f} ms a step, busy share "
            f"{prof['device_busy_share']:.3f}, port kernels {prof['port_kernels']}")
        # One kernel per counted launch: the reduce is one launch.
        seen = {k: prof["port_kernels"].get(k, {}).get("launches", 0)
                for k in LAUNCHES_PER_STEP}
        out["by_route"][name]["launches_seen_per_step"] = seen
        if name == "kernel_eager" and seen != LAUNCHES_PER_STEP:
            raise RuntimeError(f"the {name} profile saw {seen} kernels per step, "
                               f"expected {LAUNCHES_PER_STEP}")
    del runs, m, st, stp
    fastest = min(("eager", "graph", "compile"),
                  key=lambda r: out["by_route"][f"kernel_{r}"]["ms_per_step"])
    out["fastest_train_route"] = fastest
    out["kernel_route_images_per_s"] = out["by_route"][f"kernel_{TRAIN_ROUTE}"]["images_per_s"]
    out["torch_route_images_per_s"] = out["by_route"]["torch_eager"]["images_per_s"]
    log(f"[train] fastest train route {fastest}; TRAIN_ROUTE is {TRAIN_ROUTE}")
    return out


def _knob_runs(images, labels) -> dict:
    """The knobs phase's ``remat`` runs, under deterministic algorithms, with
    dropout, a rate that changes every step and the model EMA:
    ``KNOB_STEPS`` steps eager without ``remat``, eager with it, and on the
    graph route with it (the phase's main path: the counts set to 0 just
    before it and read just after)."""
    runs = {}
    for name, step_route, remat in (("plain_eager", "eager", False),
                                    ("remat_eager", "eager", True),
                                    ("remat_graph", "graph", True)):
        model, state, step = _train_setup(torch.bfloat16, "auto", seed=2, step_route=step_route,
                                          schedule=True, model_ema=0.999, remat=remat)
        if name == "remat_graph":
            for fn in COUNTERS.values():
                fn.launches = 0
        losses = []
        with deterministic():
            for _ in range(KNOB_STEPS):
                state, metrics = step(state, images, labels)
                losses.append(metrics["loss"])
        torch.cuda.synchronize()
        runs[name] = {"losses": [float(v) for v in losses], **_snapshot(model, step, state),
                      "launches": counts(), "counted_steps": step.counted(),
                      "replays": sum(step.replays.values())}
        del model, state, step
    return runs


def knobs_phase() -> dict:
    """The model knobs' checks on the production configuration (mnasnet1_0@224,
    bs128, bf16): ``remat``, ``channel_pad`` 64 and 128 and the
    ``taps``/``taps2``/``hybrid`` depthwise routes. The compile route with
    ``remat`` and the knobs' GPU tests are the background jobs
    ``remat_compile`` and ``knob_tests``, the timing :func:`knob_timing`."""
    images, labels = train_batch()
    out = {}

    # remat: the graph route bit for bit its eager step and the plain step.
    runs = _knob_runs(images, labels)
    main = runs["remat_graph"]
    out["launches"] = main["launches"]
    out["counted_steps"] = main["counted_steps"]
    out["launches_per_step"] = LAUNCHES_PER_REMAT_STEP
    out["losses"] = main["losses"]
    same = {}
    for a, b in (("remat_graph", "remat_eager"), ("remat_eager", "plain_eager")):
        same[f"{a}_vs_{b}"] = {"losses": runs[a]["losses"] == runs[b]["losses"],
                               **{k: _tree_equal(runs[a][k], runs[b][k])
                                  for k in ("model", "tx", "generator")}}
    out["remat_bitwise"] = same
    log(f"[knobs] remat over {KNOB_STEPS} steps, bitwise: {json.dumps(same)}; graph route "
        f"launches {main['launches']} over {main['counted_steps']} counted steps, "
        f"{main['replays']} replays")
    if not all(all(v.values()) for v in same.values()):
        raise RuntimeError(f"remat is not bit for bit the step: {same}")
    if main["launches"] != _scaled(LAUNCHES_PER_REMAT_STEP, main["counted_steps"]) \
            or main["replays"] != KNOB_STEPS - 1:
        raise RuntimeError(f"expected {LAUNCHES_PER_REMAT_STEP} launches per counted remat "
                           f"step and {KNOB_STEPS - 1} replays: {main}")
    del runs, main

    # The production step with remat, the reference of the routes below.
    first = {"eager": _first_step("eager", images, labels, remat=True),
             "eager_one_ulp": _first_step("eager", one_ulp(images), labels, remat=True)}
    base = first["eager"]

    # The depthwise routes and the padded models: each first step against
    # the production step (kernel route) within the same one-ulp bars.
    out["first_step_vs_best"] = {}
    for name, kw in (("best-taps", {"dw_impl": "taps"}), ("best-taps2", {"dw_impl": "taps2"}),
                     ("best-hyb2", {"dw_impl": "hybrid"})):
        ours = _first_step("eager", images, labels, route="auto", **kw)
        comp = _held_to_one_ulp(ours, base, first["eager_one_ulp"], f"{name}'s first step")
        out["first_step_vs_best"][name] = comp
        log(f"[knobs] {name} first step vs best: {json.dumps(comp)}")
    out["channel_pad"] = {}
    for pad in (64, 128):
        runs = {r: _first_step("eager", x, labels, route=r, channel_pad=pad)
                for r, x in (("kernel", images), ("torch", images))}
        moved = _first_step("eager", one_ulp(images), labels, route="torch", channel_pad=pad)
        comp = _held_to_one_ulp(runs["kernel"], runs["torch"], moved,
                                f"channel_pad={pad}'s kernel route against its torch route")
        # The serving forward's launches: the blocks the planner still admits.
        model = create_model("mnasnet1_0", dtype=torch.bfloat16, channel_pad=pad)
        predict = make_predict_fn(model)
        before = counts()
        predict(images)
        torch.cuda.synchronize()
        comp["serving_launches"] = _delta(before, counts())
        out["channel_pad"][pad] = comp
        log(f"[knobs] channel_pad={pad} kernel route vs torch route: {json.dumps(comp)}")
        del runs, moved, model, predict
    del first, base
    return out


def knob_gpu_tests() -> dict:
    """The knobs' tests of ``tests/test_torch_gpu.py`` in a child pytest
    (``--noconftest``: no JAX): ``remat`` on the graph route, taps and
    hybrid gradients at the stride-2 shapes, the padded kernel route."""
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                        "-q", "-m", "gpu", "-k", "remat or taps or channel_pad",
                        "tests/test_torch_gpu.py"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"[knobs] GPU tests of the knobs: {summary}")
    if r.returncode != 0 or " passed" not in summary or "failed" in summary:
        raise RuntimeError(f"the knobs' GPU tests failed (rc {r.returncode}):\n"
                           f"{r.stdout[-4000:]}{r.stderr[-2000:]}")
    return {"summary": summary}


def knob_timing(card: str) -> dict:
    """ms per step, images/s, peak memory and launches per step of the
    variants (``tools/train_variants.py``) on the train phase's batch, and
    the serving forward per ``pw_lowering``; conv and dot in alternating
    runs."""
    images, labels = train_batch()
    rows = []

    def train(name, route, x=images, y=labels, **kw):
        row = {"variant": name, **time_train({**VARIANTS["best"], **kw}, route, x, y,
                                             target_ms=KNOB_TARGET_MS)}
        rows.append(row)
        log(f"[knobs] {name} bs{x.shape[0]} {route}: {row['ms_per_step']:.3f} ms/step, "
            f"{row['images_per_s']:.1f} images/s, peak {row['peak_allocated_gb']:.2f} GB "
            f"allocated / {row['peak_reserved_gb']:.2f} reserved, launches "
            f"{row['launches_per_step']} on {card}")

    for lowering in PW_ORDER:
        train(f"best-pw{lowering}", TRAIN_ROUTE, pw_lowering=lowering)
    for remat in (False, True):
        train("best-remat" if remat else "best", TRAIN_ROUTE, remat=remat)
    big = variant_batch(REMAT_BIG_BATCH, torch.device("cuda"))
    for remat in (False, True):
        train("best-remat" if remat else "best", TRAIN_ROUTE, *big, remat=remat)
    del big
    for pad in (64, 128):
        train(f"best-cpad{pad}", TRAIN_ROUTE, channel_pad=pad)
    for name, impl in (("best-taps", "taps"), ("best-taps2", "taps2"), ("best-hyb2", "hybrid")):
        train(name, TRAIN_ROUTE, dw_impl=impl)
    train("best", "eager")
    serving = []
    for dw_impl in ("auto", "torch"):
        for bs in (1, BATCH):
            for lowering in PW_ORDER:
                serving.append(time_serving(lowering, bs, torch.device("cuda"),
                                            target_ms=KNOB_TARGET_MS / 2, dw_impl=dw_impl))
                log(f"[knobs] serving pw_lowering={lowering} dw_impl={dw_impl} bs{bs} graph: "
                    f"{serving[-1]['ms_per_batch']:.4f} ms on {card}")
    verdict = {"train": pw_verdict([(r["variant"][len("best-pw"):], r["ms_per_step"])
                                    for r in rows if r["variant"].startswith("best-pw")])}
    for dw_impl in ("auto", "torch"):
        for bs in (1, BATCH):
            verdict[f"serving_{dw_impl}_bs{bs}"] = pw_verdict(
                [(r["pw_lowering"], r["ms_per_batch"]) for r in serving
                 if r["batch"] == bs and r["dw_impl"] == dw_impl])
    log(f"[knobs] pw_lowering per mode: {json.dumps(verdict)}; PW_AUTO is {PW_AUTO}")
    return {"train": rows, "serving": serving, "pw_lowering": verdict}


def pw_verdict(times: list) -> dict:
    """conv against dot from alternating runs of fresh builds: each
    lowering's mean, the noise (the largest spread among one lowering's
    runs) and the faster one, or "within noise" where the means differ by
    no more than the noise."""
    by = {lw: [t for name, t in times if name == lw] for lw in ("dot", "conv")}
    mean = {lw: sum(v) / len(v) for lw, v in by.items()}
    noise = max(max(v) - min(v) for v in by.values())
    faster = min(mean, key=mean.get) if abs(mean["dot"] - mean["conv"]) > noise \
        else "within noise"
    return {"ms": by, "mean_ms": mean, "noise_ms": noise, "faster": faster}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _scaled(per: dict, n: int) -> dict:
    return {k: v * n for k, v in per.items()}


@contextlib.contextmanager
def _patched(obj, name, wrapper):
    orig = getattr(obj, name)
    setattr(obj, name, wrapper(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def routed_forwards(routed, calls_before: dict) -> dict:
    """The forwards a ``BatchRouted`` ran since its ``calls`` were
    ``calls_before``, by route, and how many of them its kernels' launch
    counters saw: every eager and compiled call, and for each graph key
    captured in that span its warm-ups and its capture (a replay launches
    the kernels without their wrappers)."""
    by_route = dict.fromkeys(ROUTES, 0)
    counted = 0
    for key, n in routed.calls.items():
        new = n - calls_before.get(key, 0)
        by_route[key[0]] += new
        if key[0] != "graph":
            counted += new
        elif key not in calls_before:
            counted += GRAPH_WARMUP + 1
    return {"by_route": by_route, "counted": counted}


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Record, for each call of ``Trainer.train_epoch``, ``Trainer.validate``
    and ``recalibrate_bn`` made inside, the kernel launches it made and the
    steps or batches it ran (for validation, also the routed eval step's
    forwards by route: :func:`routed_forwards`; for training, the train
    route, its calls and the steps the counters saw: ``TrainRouted.counted``)."""
    def record(kind):
        def wrapper(orig):
            def call(*a, **kw):
                before, t0 = counts(), time.perf_counter()
                routed_before = dict(a[0]._eval_step.calls) if kind == "validate" else None
                train_step = a[0]._train_step if kind == "train_epoch" else None
                if train_step is not None:
                    counted0, calls0 = train_step.counted(), sum(train_step.calls.values())
                out = orig(*a, **kw)
                torch.cuda.synchronize()
                row = {"kind": kind, "launches": _delta(before, counts()),
                       "s": time.perf_counter() - t0}
                if kind == "train_epoch":
                    row["steps"] = out.step
                    row["loss"] = a[0].epoch_train_stats["loss"]
                    row["route"] = train_step.route
                    row["step_calls"] = sum(train_step.calls.values()) - calls0
                    row["counted_steps"] = train_step.counted() - counted0
                elif kind == "validate":
                    row["forwards"] = a[2].steps_per_epoch()
                    row["routes"] = routed_forwards(a[0]._eval_step, routed_before)
                else:
                    row["forwards"] = kw["num_batches"]
                calls.append(row)
                return out
            return call
        return wrapper

    with _patched(Trainer, "train_epoch", record("train_epoch")), \
            _patched(Trainer, "validate", record("validate")), \
            _patched(bn_recal, "recalibrate_bn", record("recalibrate_bn")):
        yield


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv: list) -> str:
    """``python -m mnasnet_tpu_torch.train`` in this process; its stdout is
    shown and returned."""
    log(f"[trainer] train CLI: {' '.join(argv)}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        train_cli.main(argv)
    return buf.getvalue()


def write_image_folder(root: Path) -> Path:
    """A seeded ImageFolder of JPEGs: smooth random images of 256-400 px a
    side, ``FOLDER_CLASSES`` classes, under ``train/`` and ``val/``."""
    rng = np.random.default_rng(0)
    for split, per_class in (("train", FOLDER_TRAIN), ("val", FOLDER_VAL)):
        for c in range(FOLDER_CLASSES):
            d = root / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(per_class):
                w, h = (int(v) for v in rng.integers(256, 401, 2))
                small = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
                img = Image.fromarray(small).resize((w, h), Image.Resampling.BILINEAR)
                img.save(d / f"{i}.jpg", quality=90)
    return root


def _final_payload(out: Path) -> dict:
    from mnasnet_tpu_torch.train.checkpoint import CheckpointManager

    key = CheckpointManager(str(out)).latest_epoch()
    return torch.load(out / str(key) / "checkpoint.pt", map_location="cpu", weights_only=True)


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def folder_run(work: Path, workers: int) -> dict:
    """(a): one epoch over an ImageFolder, BN recalibration, the eval CLI."""
    data = write_image_folder(work / "data")
    out = work / "folder_run"
    calls: list = []
    for fn in COUNTERS.values():  # the main path: counts set to 0 just before
        fn.launches = 0
    with recorded_calls(calls):
        text = run_cli([str(data), "--arch", "mnasnet1_0", "--batch-size", str(BATCH),
                        "--epochs", "1", "--bn-recalibrate", "2", "--workers", str(workers),
                        "--num-classes", str(FOLDER_CLASSES), "--seed", "0",
                        "--print-freq", "1", "--decoder", "native-fast",
                        "--output-dir", str(out)])
    torch.cuda.synchronize()
    launches = counts()
    res = {"launches": launches, "calls": calls}
    log(f"[trainer] ImageFolder run: launches {launches}; calls {json.dumps(calls)}")
    kinds = [c["kind"] for c in calls]
    if kinds != ["train_epoch", "validate", "recalibrate_bn", "validate"]:
        raise RuntimeError(f"unexpected call sequence {kinds}")
    train, val0, recal, val1 = calls
    spe = FOLDER_CLASSES * FOLDER_TRAIN // BATCH
    val_batches = -(-FOLDER_CLASSES * FOLDER_VAL // BATCH)  # the tail padded
    # The train step runs on the default train route: its launches are
    # those of the steps the counters see (a graph replay launches the
    # kernels without their wrappers), and every batch ran once.
    if train["steps"] != spe or train["step_calls"] != spe or train["route"] != TRAIN_ROUTE \
            or train["launches"] != _scaled(LAUNCHES_PER_STEP, train["counted_steps"]):
        raise RuntimeError(f"train epoch: {train}; expected {spe} steps on the {TRAIN_ROUTE} "
                           f"route, the counted ones of {LAUNCHES_PER_STEP}")
    if not np.isfinite(train["loss"]):
        raise RuntimeError(f"train epoch loss not finite: {train['loss']}")
    # Validation runs its eval step on the route of each batch size: the
    # launches are those of the forwards the counters see (graph replays
    # launch the kernels without their wrappers), and every batch ran once.
    for val in (val0, val1):
        routes = val["routes"]
        if val["forwards"] != val_batches or sum(routes["by_route"].values()) != val_batches \
                or val["launches"] != _scaled(LAUNCHES_PER_VAL_FORWARD, routes["counted"]):
            raise RuntimeError(f"validation: {val}; expected {val_batches} forwards, the "
                               f"counted ones of {LAUNCHES_PER_VAL_FORWARD}")
    if recal["launches"] != _scaled(LAUNCHES_PER_RECAL_FORWARD, 2):
        raise RuntimeError(f"recalibration: {recal}; expected 2 forwards of "
                           f"{LAUNCHES_PER_RECAL_FORWARD}")
    if sum(launches.values()) != sum(sum(c["launches"].values()) for c in calls):
        raise RuntimeError("kernel launches outside the recorded calls")
    present = sorted(os.listdir(out))
    if not {"0", "1", "best"} <= set(present):
        raise RuntimeError(f"checkpoints {present}; expected 0/, 1/ (recalibrated) and best/")
    from mnasnet_tpu_torch.train.checkpoint import CheckpointManager

    best = CheckpointManager(str(out)).best_epoch()
    printed = {0: [ln for ln in text.splitlines() if ln.startswith("epoch 0: acc1=")],
               1: [ln for ln in text.splitlines() if ln.startswith("bn-recalibrated: acc1=")]}
    acc1 = printed[best][0].split("acc1=")[1].split(" ")[0]
    res["printed"] = {k: v[0] for k, v in printed.items()}
    res["best_epoch"] = best
    r = subprocess.run([sys.executable, "-m", "mnasnet_tpu_torch.eval", str(data), "--resume",
                        str(out), "--best", "--dtype", "bfloat16", "-b", str(BATCH),
                        "--workers", str(workers)], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    log(f"[trainer] eval CLI, rc {r.returncode}:\n{r.stdout[-600:]}{r.stderr[-2000:]}")
    scored = [ln for ln in r.stdout.splitlines() if ln.startswith(" * Acc@1 ")]
    res["eval_cli"] = scored[0] if scored else None
    if r.returncode != 0 or not scored or scored[0].split()[2] != acc1:
        raise RuntimeError(f"the eval CLI printed {scored} for best/ (key {best}); the "
                           f"trainer printed acc1={acc1}")
    return res


def preempt_runs(work: Path, workers: int) -> dict:
    """(b): SIGTERM after step 2 of a --deterministic run, then --resume;
    bitwise against the uninterrupted run."""
    argv = ["--synthetic", "--synthetic-size", str(4 * BATCH), "--batch-size", str(BATCH),
            "--deterministic", "--epochs", "1", "--workers", str(workers), "--print-freq", "1"]
    ref, pre = work / "ref", work / "preempted"
    run_cli([*argv, "--output-dir", str(ref)])

    def with_sigterm(orig):
        def call(self, state, loader, epoch, step_callback=None, step_callback_freq=0,
                 start_step=0):
            return orig(self, state, loader, epoch, start_step=start_step,
                        step_callback=lambda s, g: os.kill(os.getpid(), signal.SIGTERM),
                        step_callback_freq=2)
        return call

    with _patched(Trainer, "train_epoch", with_sigterm):
        text = run_cli([*argv, "--output-dir", str(pre)])
    if "preempted at global step 2" not in text or not (pre / "preempt" / "2").is_dir():
        raise RuntimeError("the SIGTERM run did not stop at global step 2 with a checkpoint")
    text = run_cli([*argv, "--output-dir", str(pre), "--resume", str(pre)])
    if "resumed from preemption checkpoint: epoch 0 step 2" not in text:
        raise RuntimeError("the resumed run did not start at step 2")
    a, b = _final_payload(ref), _final_payload(pre)
    same = {k: _tree_equal(a[k], b[k]) for k in ("model", "optimizer", "train_state")}
    log(f"[trainer] SIGTERM after step 2 and resume vs uninterrupted, bitwise: {same}")
    if not all(same.values()) or a["train_state"]["step"] != 4:
        raise RuntimeError(f"the resumed run differs from the uninterrupted one: {same}")
    return {"bitwise_equal": same, "steps": a["train_state"]["step"]}


def throughput(work: Path, workers: int, card: str) -> dict:
    """(c): images/s of Trainer.train_epoch on synthetic data with the data
    path included (steps 2..10 of 10), and the loaders alone."""
    model = create_model("mnasnet1_0", dtype=torch.bfloat16, bn_ema="external", stem_s2d=True)
    tx = create_optimizer("rmsprop", TRAIN_LR, fused="small")
    trainer = Trainer(model, tx, label_smoothing=0.1, compute_dtype=torch.bfloat16,
                      print_freq=THROUGHPUT_STEPS)
    state = trainer.create_state(0)
    loader = DataLoader(SyntheticDataset(THROUGHPUT_STEPS * BATCH, IMAGE, 1000, seed=0), BATCH,
                        lambda img, rng: train_transform(img, IMAGE, rng), shuffle=True,
                        drop_last=True, workers=workers)
    marks = {}

    def mark(state, gstep):
        if gstep in (0, THROUGHPUT_STEPS - 1):
            torch.cuda.synchronize()
            marks[gstep] = time.perf_counter()

    trainer.train_epoch(state, loader, 0, step_callback=mark, step_callback_freq=1)
    steps = THROUGHPUT_STEPS - 1
    out = {"steps_timed": steps,
           "images_per_s_with_data": steps * BATCH / (marks[steps] - marks[0]),
           "cpu_count": os.cpu_count(), "workers": workers}

    def loader_rate(batches) -> float:
        t0 = None
        n = 0
        for i, (x, _) in enumerate(batches):
            torch.cuda.synchronize()
            if i == 0:
                t0 = time.perf_counter()
            else:
                n += 1
        return n / (time.perf_counter() - t0)

    out["synthetic_loader_batches_per_s"] = loader_rate(
        prefetch_to_device(loader.epoch(1), device="cuda", dtype=torch.bfloat16))
    # The host batches alone (decode, augment, collate): what the cast, the
    # pinned copy and the transfer add is the difference.
    out["synthetic_host_batches_per_s"] = loader_rate(loader.epoch(2))
    jpeg = DataLoader(ImageFolderDataset(str(work / "data" / "train")), BATCH,
                      lambda img, rng: train_transform(img, IMAGE, rng), shuffle=True,
                      drop_last=True, workers=workers, bytes_transform=(
                          (lambda d, rng: native_decoder.decode_train(d, IMAGE, rng))
                          if native_decoder.available() else None))

    def epochs(n):
        for e in range(n):
            yield from jpeg.epoch(e)

    out["jpeg_loader_batches_per_s"] = loader_rate(
        prefetch_to_device(epochs(3), device="cuda", dtype=torch.bfloat16))
    out["jpeg_decoder"] = "native-fast" if native_decoder.available() else "PIL"
    log(f"[trainer] throughput with the data path: {out['images_per_s_with_data']:.1f} "
        f"images/s over {steps} steps of bs{BATCH}; loaders alone: synthetic "
        f"{out['synthetic_loader_batches_per_s']:.2f} batches/s (host batches alone "
        f"{out['synthetic_host_batches_per_s']:.2f}), JPEG "
        f"({out['jpeg_decoder']}) {out['jpeg_loader_batches_per_s']:.2f} batches/s; "
        f"{workers} workers, {os.cpu_count()} CPUs, on {card}")
    del model, tx, trainer, state
    return out


def _step_kind(kind, replicas=None):
    """fp32 production model (seed 1, kernel route) and its step: "sync",
    "local" (with ``replicas``), "one" or "accum<K>" (one process). The BN
    EMA's decay is 0, so that the running statistics after the step are the
    step's batch moments, which the comparison reads."""
    model = create_model("mnasnet1_0", dtype=torch.float32, bn_ema="external", stem_s2d=True,
                         seed=1, dw_impl="kernel", bn_bwd="kernel", bn_momentum=0.0)
    tx = create_optimizer("rmsprop", TRAIN_LR, fused="small")
    state = TrainState.create(model, tx, seed=1)
    if kind == "sync":
        set_replicas(model, replicas)
        step = make_train_step(model, tx, 0.1, replicas=replicas)
    elif kind == "local":
        step = make_local_bn_train_step(model, tx, 0.1, replicas)
    else:
        step = make_train_step(model, tx, 0.1, grad_accum=int(kind[5:]) if kind != "one" else 1,
                               route="eager")
    return model, state, step


def _one_step(kind, images, labels, replicas=None) -> dict:
    model, state, step = _step_kind(kind, replicas)
    p0 = {n: p.detach().cpu() for n, p in model.named_parameters()}
    for fn in COUNTERS.values():  # counts set to 0 just before the step
        fn.launches = 0
    before = replicas.collectives if replicas is not None else 0
    state, metrics = step(state, images, labels)
    torch.cuda.synchronize()
    return {"launches": counts(), "loss": float(metrics["loss"]), "route": step.route,
            "counted": step.counted(),
            "collectives": (replicas.collectives if replicas is not None else 0) - before,
            "p0": p0, "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "stats": {n: b.cpu() for n, b in model.named_buffers()
                      if n.endswith(("mean", "var"))}}


def dist_rank(rank: int, world: int, backend: str, rendezvous: str, out_dir: str) -> None:
    """(b), one of ``world`` ranks: one sync-BN and one local-BN fp32 step on
    this rank's share of the train phase's batch; over gloo every rank is
    on cuda:0, over NCCL on its own card. The results go to ``rank<R>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda:0" if backend == "gloo" else f"cuda:{rank}"
    replicas = init_distributed(f"file://{rendezvous}", world, rank, backend, device)
    try:
        images, labels = train_batch()
        rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
        out = {kind: _one_step(kind, images[rows], labels[rows], replicas)
               for kind in ("sync", "local")}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close(replicas)


def _update_rel_rms(ours: dict, ref: dict) -> float:
    """|Δp_ours − Δp_ref| / |Δp_ref| over all parameters."""
    p0, pa, pb = ref["p0"], ours["params"], ref["params"]
    num = sum(float(((pa[n] - pb[n]) ** 2).sum()) for n in pb)
    den = sum(float(((pb[n] - p0[n]) ** 2).sum()) for n in pb)
    return (num / den) ** 0.5


def _moments_diff(ours: dict, ref: dict) -> float:
    """The largest difference of the step's BN moments, each channel's mean
    in units of its standard deviation and its variance relative to itself
    (a mean near 0 has no relative error to speak of)."""
    worst = 0.0
    for n, v in ref.items():
        if n.endswith("running_var"):
            m = n[:-len("var")] + "mean"
            sd = v.clamp(min=1e-12).sqrt()
            worst = max(worst, float(((ours[m] - ref[m]).abs() / sd).max()),
                        float(((ours[n] - v).abs() / v.clamp(min=1e-12)).max()))
    return worst


def _vs_one_process(ours: dict, ref: dict, moved: dict) -> dict:
    """``ours`` against the one-process step ``ref``; ``moved`` is that step
    on images moved by one ulp, whose update differs from ``ref``'s by the
    step's own sensitivity to rounding."""
    return {"loss": ours["loss"], "loss_one_process": ref["loss"],
            "loss_rel_diff": abs(ours["loss"] - ref["loss"]) / abs(ref["loss"]),
            "update_rel_rms_diff": _update_rel_rms(ours, ref),
            "one_ulp_update_rel_rms_diff": _update_rel_rms(moved, ref),
            "moments_max_diff": _moments_diff(ours["stats"], ref["stats"]),
            "bitwise": all(torch.equal(ours["params"][n], ref["params"][n])
                           for n in ref["params"])
            and all(torch.equal(ours["stats"][n], ref["stats"][n]) for n in ref["stats"])}


def ranks_vs_one_process(work: Path, world: int, backend: str) -> dict:
    """(b): ``world`` ranks against one process: the sync-BN step against the
    step on the whole batch, the local-BN step against ``grad_accum=world``."""
    import torch.multiprocessing as mp

    mp.start_processes(dist_rank, args=(world, backend, str(work / "rendezvous"), str(work)),
                       nprocs=world, start_method="spawn")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=True) for r in range(world)]
    images, labels = train_batch()
    out = {"world": world, "backend": backend, "launches": ranks[0]["sync"]["launches"]}
    where = "cuda:0" if backend == "gloo" else "one card each"
    for kind, ref_kind in (("sync", "one"), ("local", f"accum{world}")):
        mine = [r[kind] for r in ranks]
        a = mine[0]
        replicated = all(b["loss"] == a["loss"] and all(
            torch.equal(a[f][n], b[f][n]) for f in ("params", "stats") for n in a[f])
            for b in mine[1:])
        nudged = images * (1 + 2.0 ** -23 * torch.randint(
            0, 2, images.shape, device=images.device, generator=torch.Generator(
                device=images.device).manual_seed(12)).mul(2).sub(1))
        cmp = _vs_one_process(a, _one_step(ref_kind, images, labels),
                              _one_step(ref_kind, nudged, labels))
        model = create_model("mnasnet1_0", device="cpu", bn_bwd="kernel")
        # A graph's first call counts twice (its warm-up step and its capture).
        counted = a["counted"]
        predicted = step_collectives(model, sync_bn=kind == "sync") * counted + (
            BN_PLANE_SIZES if kind == "sync" else 0)
        row = {**cmp, "ranks_bitwise_equal": replicated, "route": a["route"],
               "counted": counted, "launches": [b["launches"] for b in mine],
               "collectives": [b["collectives"] for b in mine],
               "collectives_predicted": predicted, "against": ref_kind}
        out[kind] = row
        log(f"[dist] {backend}, {world} ranks on {where}, {kind} step vs one process "
            f"({ref_kind}): {json.dumps(row)}")
        if not replicated:
            raise RuntimeError(f"the ranks' {kind} steps ended in different states")
        if a["route"] != ("eager" if backend == "gloo" else TRAIN_ROUTE):
            raise RuntimeError(f"{kind} over {backend} took the {a['route']} route")
        if any(b["launches"] != _scaled(LAUNCHES_PER_STEP, counted) for b in mine):
            raise RuntimeError(f"{kind}: launches per rank {row['launches']}, expected "
                               f"{LAUNCHES_PER_STEP} x {counted}")
        if row["collectives"] != [predicted] * world:
            raise RuntimeError(f"{kind}: collectives {row['collectives']}, predicted {predicted}")
        if cmp["loss_rel_diff"] > 1e-5 or cmp["moments_max_diff"] > 1e-5 \
                or cmp["update_rel_rms_diff"] > max(1e-2, 4 * cmp["one_ulp_update_rel_rms_diff"]):
            raise RuntimeError(f"{kind} over {world} ranks disagrees with one process: {cmp}")
    return out


def fixed_worker(out: Path) -> int:
    """(a), first torchrun: :func:`fixed_batch_routes` in each process it
    starts; the record goes to ``out/fixed_rank<R>.json``."""
    # A rank that waits on its peers past this bound prints every thread's
    # stack and exits, which ends the others' run too.
    faulthandler.dump_traceback_later(DIST_WORKER_S, exit=True)
    record = fixed_batch_routes()
    (out / f"fixed_rank{os.environ.get('RANK', 0)}.json").write_text(json.dumps(record))
    faulthandler.cancel_dump_traceback_later()
    return 0


def dist_worker(out: Path, argv: list) -> int:
    """(a), second torchrun, in each process it starts: the train CLI's
    ``main(argv)``, recording each step's launches, collectives and counted
    steps (``TrainRouted.counted``: a graph's first call counts its warm-up
    and its capture, a replay nothing) and the images/s of the steps after
    the first (before the profiled window, when there is one); the record
    goes to ``out/rank<R>.json``. A process joins one group only: a second
    ``env://`` group in the same torchrun would meet the first one's keys
    in torchrun's store."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    faulthandler.dump_traceback_later(DIST_WORKER_S, exit=True)
    record: dict = {"argv": argv}
    steps = []
    marks = {}
    last = (DIST_PROFILE_STEPS[0] if "--profile-steps" in argv else DIST_STEPS) - 1
    before: dict = {}

    def with_record(orig):
        def call(self, state, loader, epoch, step_callback=None, step_callback_freq=0,
                 start_step=0):
            record["collectives_per_step"] = self.collectives_per_step()
            record["replicas"] = repr(self.replicas)
            record["route"] = self.route.route
            before.update(launches=counts(), collectives=self.replicas.collectives,
                          counted=self.route.counted())

            def mark(state, gstep):
                c, k, n = self.replicas.collectives, counts(), self.route.counted()
                steps.append({"launches": _delta(before["launches"], k),
                              "collectives": c - before["collectives"],
                              "counted": n - before["counted"]})
                before.update(launches=k, collectives=c, counted=n)
                if gstep in (0, last):
                    torch.cuda.synchronize()
                    marks[gstep] = time.perf_counter()

            out = orig(self, state, loader, epoch, step_callback=mark, step_callback_freq=1,
                       start_step=start_step)
            record["replays"] = sum(self.route.replays.values())
            return out
        return call

    for fn in COUNTERS.values():  # the main path: counts set to 0 just before
        fn.launches = 0
    base = memory_base(torch.device("cuda"))
    with _patched(Trainer, "train_epoch", with_record):
        train_cli.main(argv)
    torch.cuda.synchronize()
    record.update(steps=steps, launches=counts(), steps_timed=last, world=world,
                  images_per_s=last * BATCH * world / (marks[last] - marks[0]),
                  peak_allocated_gb=(torch.cuda.max_memory_allocated() - base[0]) / 1e9)
    (out / f"rank{os.environ.get('RANK', 0)}.json").write_text(json.dumps(record))
    faulthandler.cancel_dump_traceback_later()
    return 0


def _dp_setup(kind, replicas, route):
    """The production configuration in bf16 (seed 2, dropout, a warmup-cosine
    rate that changes every step, the model EMA with warmup) and its
    data-parallel step on ``route``: ``kind`` "sync", "local" or
    "sync_remat"."""
    model, state, first = _train_setup(torch.bfloat16, "auto", seed=2, step_route="eager",
                                       schedule=True, model_ema=0.999,
                                       remat=kind == "sync_remat")
    tx = first._steps.tx
    if kind == "local":
        return model, state, make_local_bn_train_step(model, tx, 0.1, replicas, route=route)
    set_replicas(model, replicas)
    return model, state, make_train_step(model, tx, 0.1, replicas=replicas, route=route)


def _dp_bitwise(replicas, images, labels) -> dict:
    """Per kind (sync, local, sync_remat): ``DP_STEPS`` steps with dropout, a
    changing rate and the model EMA under deterministic algorithms, on the
    graph route (its warm-up step, the capture with the collectives inside,
    replays) and eagerly, from the same weights: the losses, parameters, BN
    buffers with ``num_batches_tracked``, optimizer state and generator bit
    for bit, at every world: at world N NCCL reduces in one order inside a
    graph and eagerly (measured on four cards). A kind that is not bit for
    bit on any rank fails the phase on every rank."""
    out = {}
    for kind in DP_KINDS:
        runs = {}
        for route in ("eager", "graph"):
            model, state, step = _dp_setup(kind, replicas, route)
            losses = []
            with deterministic():
                for _ in range(DP_STEPS):
                    state, metrics = step(state, images, labels)
                    losses.append(metrics["loss"])
            torch.cuda.synchronize()
            runs[route] = {"losses": [float(v) for v in losses], **_snapshot(model, step, state),
                           "replays": sum(step.replays.values()), "counted": step.counted()}
            del model, state, step
        same = {"losses": runs["graph"]["losses"] == runs["eager"]["losses"],
                **{k: _tree_equal(runs["graph"][k], runs["eager"][k])
                   for k in ("model", "tx", "generator")}}
        row = {"bitwise": same, "losses": runs["eager"]["losses"],
               "graph_replays": runs["graph"]["replays"],
               "graph_counted": runs["graph"]["counted"]}
        log(f"[dist] rank {replicas.rank} of {replicas.world}: {kind} graph route vs eager "
            f"over {DP_STEPS} steps, bitwise: {same}")
        if runs["graph"]["replays"] != DP_STEPS - 1 or runs["graph"]["counted"] != 2:
            raise RuntimeError(f"{kind}: the graph run made {runs['graph']['replays']} "
                               f"replays and {runs['graph']['counted']} counted steps")
        # Every rank raises together (a rank that went on alone would wait
        # in the next collective for the others forever).
        differs = torch.tensor([0.0 if all(same.values()) else 1.0], device=replicas.device)
        if all_reduce_max_(differs, replicas).item():
            raise RuntimeError(f"{kind} at world {replicas.world}: the graph route differs "
                               f"from eager on a rank (this rank: {same})")
        out[kind] = row
    return out


def _fixed_ms(step, state, images, labels, warmup: int = 3, iters: int = DP_TIMED) -> float:
    """ms per step from CUDA events over ``iters`` steps after ``warmup``;
    fixed counts, so that every rank issues the same collectives."""
    for _ in range(warmup):
        state, _ = step(state, images, labels)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        state, _ = step(state, images, labels)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fixed_batch_routes() -> dict:
    """Under torchrun (the group from its environment, NCCL): on the train
    phase's fixed batch (bf16, production configuration, 128 images a rank)
    (1) the graph route bit for bit eager for the sync-BN, local-BN and
    sync-BN ``remat`` steps (:func:`_dp_bitwise`); (2) in turns, ms per step
    and peak memory of the one-process step ("plain") and of the sync-BN
    step eagerly ("sync") and on the graph route ("graph_plain",
    "graph_sync"); at world 1 also the eager sync-BN step with
    ``dist.all_reduce`` made a no-op ("sync_no_collective": a sum over one
    rank is the identity). sync − plain is what the collectives cost the
    eager step, graph_sync − graph_plain what they cost inside the graph,
    sync_no_collective − plain the port's own code around them."""
    import torch.distributed as dist

    replicas = init_distributed()  # torchrun's environment, a new group
    try:
        images, labels = train_batch()
        bitwise = _dp_bitwise(replicas, images, labels)
        order = ("plain", "sync", "graph_plain", "graph_sync", "sync_no_collective",
                 "sync_no_collective", "graph_sync", "graph_plain", "sync", "plain")
        if replicas.world > 1:  # the no-op sum is the identity at world 1 only
            order = tuple(k for k in order if k != "sync_no_collective")
        ms: dict = {kind: [] for kind in order}
        peak: dict = {kind: [] for kind in order}
        for kind in order:
            base = memory_base(torch.device("cuda"))
            route = "graph" if kind.startswith("graph") else "eager"
            model = create_model("mnasnet1_0", dtype=torch.bfloat16, bn_ema="external",
                                 stem_s2d=True)
            tx = create_optimizer("rmsprop", TRAIN_LR, fused="small")
            state = TrainState.create(model, tx)
            group = None if kind.endswith("plain") else replicas
            set_replicas(model, group)
            step = make_train_step(model, tx, 0.1, replicas=group, route=route)
            no_op = (lambda *a, **kw: None) if kind == "sync_no_collective" else dist.all_reduce
            with _patched(dist, "all_reduce", lambda orig: no_op):
                ms[kind].append(_fixed_ms(step, state, images, labels))
            peak[kind].append((torch.cuda.max_memory_allocated() - base[0]) / 1e9)
            del model, tx, state, step
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        log(f"[dist] rank {replicas.rank} of {replicas.world}, fixed batch, ms per step: "
            f"{json.dumps(mean)}")
        return {"bitwise": bitwise, "ms_per_step": ms, "ms_per_step_mean": mean,
                "peak_allocated_gb": peak, "world": replicas.world,
                "collectives_per_step": step_collectives(
                    create_model("mnasnet1_0", device="cpu", bn_bwd="kernel"))}
    finally:
        close(replicas)


def _collective_ms_per_step(trace: Path, steps: int) -> dict:
    """The profiled window per step: the device time of NCCL's kernels and
    of every kernel, and the host time of the all-reduce and broadcast calls
    (the ``nccl:*`` and ``c10d::*`` ops the profiler records)."""
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in kernels if "nccl" in e.get("name", "").lower()]
    host = [e for e in events if e.get("cat") == "cpu_op"
            and e.get("name", "").startswith(("nccl:", "c10d::allreduce", "c10d::broadcast"))]
    return {"nccl_kernel_ms_per_step": sum(e["dur"] for e in nccl) / 1e3 / steps,
            "nccl_kernels_per_step": len(nccl) / steps,
            "collective_ops_per_step": len(host) / steps,
            "collective_host_ms_per_step": sum(e["dur"] for e in host) / 1e3 / steps,
            "collective_op_names": sorted({e["name"] for e in host}),
            "device_ms_per_step": sum(e["dur"] for e in kernels) / 1e3 / steps,
            "profiled_steps": steps}


def _torchrun(work: Path, nproc: int, args: list, name: str) -> None:
    """``chip_smoke.py ARGS`` in ``nproc`` processes under torchrun; raises
    unless it exits 0. The ranks' output goes to a file as it comes, so that
    a run cut at its time limit still shows how far it got."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), str(REPO / "chip_smoke.py"), *args]
    log(f"[dist] {' '.join(cmd)}")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    with open(work / f"{name}.log", "w") as f:
        try:
            rc = subprocess.run(cmd, cwd=REPO, stdout=f, stderr=subprocess.STDOUT, env=env,
                                timeout=DIST_WORKER_S + 60).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    text = (work / f"{name}.log").read_text(errors="replace")
    log(f"[dist] torchrun ({name}) rc {rc}:\n{text[-10000:]}")
    if rc != 0:
        raise RuntimeError(f"the torchrun NCCL run ({name}) failed with rc {rc}")


def nccl_torchrun(work: Path, profile_dir: Path | None, nproc: int) -> dict:
    """(a): torchrun, ``nproc`` processes (one card each), NCCL: the
    fixed-batch runs, then the train CLI at 128 images a process on the
    graph route."""
    out = work / "nccl"
    out.mkdir()
    _torchrun(work, nproc, ["--dist-fixed", str(out)], "fixed_batch")
    argv = ["--synthetic", "--synthetic-size", str(DIST_STEPS * BATCH * nproc), "--batch-size",
            str(BATCH * nproc), "--epochs", "1", "--fused-kernels", "kernel", "--dtype",
            "bfloat16", "--workers", str(max(1, min((os.cpu_count() or 1) // nproc, 16))),
            "--print-freq", "1", "--seed", "0", "--output-dir", str(work / "run")]
    if profile_dir is not None:
        argv += ["--profile-steps", "{}:{}".format(*DIST_PROFILE_STEPS)]
    _torchrun(work, nproc, ["--dist-worker", str(out), *argv], "cli")
    res = json.loads((out / "rank0.json").read_text())
    res["fixed_batch"] = json.loads((out / "fixed_rank0.json").read_text())
    per_step = res.pop("steps")
    predicted = res["collectives_per_step"]  # the step's and the stop flag
    res["launches_per_step"] = [s["launches"] for s in per_step]
    res["collectives_by_step"] = [s["collectives"] for s in per_step]
    res["counted_by_step"] = [s["counted"] for s in per_step]
    for r in range(nproc):
        rec = json.loads((out / f"rank{r}.json").read_text())
        steps = rec["steps"]
        if rec["route"] != TRAIN_ROUTE or rec["replays"] != DIST_STEPS - 1:
            raise RuntimeError(f"rank {r}: the CLI took the {rec['route']} route with "
                               f"{rec['replays']} replays, expected {TRAIN_ROUTE} with "
                               f"{DIST_STEPS - 1}")
        if len(steps) != DIST_STEPS:
            raise RuntimeError(f"rank {r}: {len(steps)} steps recorded, expected {DIST_STEPS}")
        # Launches and the step's collectives come with the counted steps: the
        # first call's warm-up and capture, none at a replay; the stop flag
        # is issued eagerly at every step, and the first step adds the
        # epoch's flag and one check of each BN plane size.
        expected = [{"launches": _scaled(LAUNCHES_PER_STEP, s["counted"]),
                     "collectives": 1 + (predicted - 1) * s["counted"]
                     + (1 + BN_PLANE_SIZES if i == 0 else 0)}
                    for i, s in enumerate(steps)]
        got = [{"launches": s["launches"], "collectives": s["collectives"]} for s in steps]
        if got != expected or [s["counted"] for s in steps] != [2] + [0] * (DIST_STEPS - 1):
            raise RuntimeError(f"rank {r}: per step {got} over counted steps "
                               f"{[s['counted'] for s in steps]}, expected {expected}")
    if profile_dir is not None:
        shutil.copy(work / "run" / "profile" / "kernels.txt",
                    profile_dir / f"profile_dist_nccl_world{nproc}.txt")
        prof = _collective_ms_per_step(work / "run" / "profile" / "trace.json",
                                       DIST_PROFILE_STEPS[1] - DIST_PROFILE_STEPS[0])
        res["profile"] = prof
        # Each replayed step issues the step's collectives from the graph
        # and the stop flag's eagerly: one NCCL kernel each across ranks.
        # Over one rank NCCL launches nothing for an in-place sum (there is
        # nothing to add or move), so world 1 shows none.
        expected = predicted if nproc > 1 else 0
        prof["nccl_kernels_expected"] = expected
        if prof["nccl_kernels_per_step"] != expected:
            raise RuntimeError(f"the profiled steps ran {prof['nccl_kernels_per_step']} NCCL "
                               f"kernels a step, expected {expected} (step_collectives "
                               f"{predicted - 1} and the stop flag, at world {nproc})")
    return res


def dist_phase(timing: bool, card: str, trainer: dict | None,
               profile_dir: Path | None) -> dict:
    """(a), (b) and (c). With one card: NCCL at world 1, two gloo ranks on
    the card, the dry run at world 1; with N cards: NCCL at world N for all
    three, one card a rank."""
    nproc = torch.cuda.device_count()
    work = REPO / "build" / "chip_smoke_dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        nccl = nccl_torchrun(work, profile_dir, nproc)
        with_data = ((trainer or {}).get("throughput") or {}).get("images_per_s_with_data")
        log(f"[dist] NCCL world {nproc} through torchrun on the {TRAIN_ROUTE} route: launches "
            f"per step {nccl['launches_per_step'][:2]}... over counted steps "
            f"{nccl['counted_by_step']}, collectives per step {nccl['collectives_by_step']} "
            f"(a replay issues {nccl['collectives_per_step'] - 1} from the graph and the stop "
            f"flag's), {nccl['images_per_s']:.1f} images/s with the data path against "
            f"{with_data if with_data is None else round(with_data, 1)} in the trainer phase "
            f"(one process, no group), peak {nccl['peak_allocated_gb']:.2f} GB, on {card}; "
            f"fixed batch {json.dumps(nccl.get('fixed_batch'))}; "
            f"profile {json.dumps(nccl.get('profile'))}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # (b) and (c): background jobs, started here unless a full run did so.
    farm_start("dist_ranks", "dist_dryrun")
    return {"nccl": nccl, "ranks": farm_result("dist_ranks"),
            "trainer_images_per_s_with_data": with_data,
            "dryrun_multichip": farm_result("dist_dryrun")}


def dist_ranks() -> dict:
    """The dist phase's (b), a background job: two gloo ranks on the one
    card, or NCCL over every card of a machine with more, against one
    process."""
    nproc = torch.cuda.device_count()
    work = FARM_WORK / "ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        return (ranks_vs_one_process(work, 2, "gloo") if nproc == 1
                else ranks_vs_one_process(work, nproc, "nccl"))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def dist_dryrun() -> dict:
    """The dist phase's (c), a background job: ``dryrun_multichip`` over
    every card."""
    nproc = torch.cuda.device_count()
    t0 = time.perf_counter()
    dryrun_multichip(nproc)
    s = time.perf_counter() - t0
    log(f"[dist] dryrun_multichip({nproc}) on the card: ok in {s:.1f} s")
    return {"world": nproc, "s": s}


# The spatial phase: a 1x2 data x spatial mesh on one card (two gloo ranks
# on cuda:0), and on a machine with four cards a 2x2 mesh over NCCL. Steps
# each rank times after its first, and the steps of the 2x2 graph-vs-eager
# run.
SPATIAL_TIMED = 5
SPATIAL_BITWISE_STEPS = 3


def _band_launches(model, replicas) -> dict:
    """The kernel launches one train step and one eval forward of the
    production model at IMAGE px make on this rank, by the band plan: a dw
    launch for each depthwise conv whose output band on this rank has rows
    (train: the separable and the 16 blocks' dw; eval: the separable dw,
    the blocks on the fused MBConv kernel), and a stats, an apply, a reduce
    and a dx for each of the 35 BN+ReLU regions, when no BN plane leaves this
    rank without rows."""
    parts, i = replicas.mesh.spatial, replicas.mesh.spatial_index(replicas.rank)

    def has_rows(h, k, stride):
        return int(conv_windows(h, parts, k, stride)[i].count > 0)

    sep, *blocks = model.spatial_convs(IMAGE)[1:]
    if not all(b > a for h, _ in model.planes(IMAGE, IMAGE)[1:] for a, b in [bands(h, parts)[i]]):
        raise RuntimeError("a BN plane of the production model leaves a rank without rows")
    return {"train": {"dw_conv_bn_act": has_rows(*sep) + sum(has_rows(*c) for c in blocks),
                      "bn_bwd_reduce": 35, "bn_bwd_dx": 35, "mbconv_block": 0,
                      "bn_fwd_stats": 35, "bn_relu_apply": 35},
            "eval": {"dw_conv_bn_act": has_rows(*sep), "bn_bwd_reduce": 0, "bn_bwd_dx": 0,
                     "mbconv_block": sum(has_rows(*c) for c in blocks), "bn_fwd_stats": 0,
                     "bn_relu_apply": 0}}


def _spatial_train(images, labels, replicas) -> dict:
    """(a) on this rank: one bf16 sync-BN step of the production
    configuration on this rank's band of its shard, counted; its peak
    memory; then ms per step over SPATIAL_TIMED more."""
    dev = images.device
    x, y = shard_batch(replicas, images, labels)
    base = memory_base(dev)
    model, state, step = _train_setup(torch.bfloat16, "kernel", replicas=replicas)
    p0 = _params(model)
    for fn in COUNTERS.values():  # counts set to 0 just before the step
        fn.launches = 0
    before = replicas.collectives
    state, met = step(state, x, y)
    torch.cuda.synchronize()
    out = {"loss": float(met["loss"]), "p0": p0, "params": _params(model),
           "stats": _stats(model), "launches": counts(),
           "collectives": replicas.collectives - before,
           "collectives_predicted": step_collectives(model, image_rows=IMAGE),
           "expected": _band_launches(model, replicas),
           "route": step.route, "band_rows": list(x.shape[1:3]),
           "peak_gb": (torch.cuda.max_memory_allocated(dev) - base[0]) / 1e9}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SPATIAL_TIMED):
        state, met = step(state, x, y)
    end.record()
    end.synchronize()
    out["ms_per_step"] = start.elapsed_time(end) / SPATIAL_TIMED
    return out


def _spatial_eval(images, labels, replicas, state_file: Path) -> dict:
    """(b) on this rank: the eval forward of the serving phase's calibrated
    weights in bf16 on this rank's band (the fused MBConv and dw kernels on
    each band's window), counted."""
    model = create_model("mnasnet1_0", dtype=torch.bfloat16, dw_impl="kernel", seed=0)
    model.load_state_dict(torch.load(state_file, weights_only=True))
    set_replicas(model, replicas)
    x, _ = shard_batch(replicas, images, labels)
    for fn in COUNTERS.values():
        fn.launches = 0
    logits = make_predict_fn(model)(x)
    torch.cuda.synchronize()
    return {"logits": logits.cpu(), "launches": counts()}


def spatial_rank(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    """One rank of a 1x2 mesh on cuda:0 (gloo): (a) and (b); the results go
    to ``rank<R>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    replicas = init_distributed(f"file://{rendezvous}", world, rank, "gloo", "cuda:0")
    try:
        use_mesh(replicas, make_mesh(world, data=1, spatial=world))
        images, labels = train_batch()
        out = {"train": _spatial_train(images, labels, replicas),
               "eval": _spatial_eval(images, labels, replicas, Path(out_dir) / "eval_state.pt")}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close(replicas)


def spatial_nccl_rank(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    """(c), one rank of a 2x2 mesh over NCCL, a card each: the sync-BN step
    on the graph route against eager, SPATIAL_BITWISE_STEPS steps with
    dropout, a changing rate and the model EMA under deterministic
    algorithms; the result goes to ``nccl<R>.pt``."""
    replicas = init_distributed(f"file://{rendezvous}", world, rank, "nccl", f"cuda:{rank}")
    try:
        use_mesh(replicas, make_mesh(world, data=world // 2, spatial=2))
        images, labels = train_batch()
        x, y = shard_batch(replicas, images[:BATCH // 2], labels[:BATCH // 2])
        runs = {}
        for route in ("eager", "graph"):
            model, state, first = _train_setup(torch.bfloat16, "auto", seed=2,
                                               step_route="eager", schedule=True,
                                               model_ema=0.999, replicas=replicas)
            step = make_train_step(model, first._steps.tx, 0.1, replicas=replicas, route=route)
            losses = []
            with deterministic():
                for _ in range(SPATIAL_BITWISE_STEPS):
                    state, metrics = step(state, x, y)
                    losses.append(metrics["loss"])
            torch.cuda.synchronize()
            runs[route] = {"losses": [float(v) for v in losses], **_snapshot(model, step, state),
                           "replays": sum(step.replays.values())}
            del model, state, step, first
        same = {"losses": runs["graph"]["losses"] == runs["eager"]["losses"],
                **{k: _tree_equal(runs["graph"][k], runs["eager"][k])
                   for k in ("model", "tx", "generator")}}
        torch.save({"bitwise": same, "replays": runs["graph"]["replays"],
                    "losses": runs["eager"]["losses"]}, os.path.join(out_dir, f"nccl{rank}.pt"))
    finally:
        close(replicas)


def _band_block_ms() -> dict:
    """(d): the fused MBConv kernel's device time at each of the 16 block
    shapes (bf16, BATCH images) on the whole plane and on each of two
    bands' windows with the crop of its output rows, from CUDA-graph
    replays: what a band of a 1x2 mesh costs beside half the plane."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, h, cin, cmid, cout, k, s in block_shapes():
        _, (x32, *weights), kw = random_block(h, cin, cmid, cout, k, s, g)
        x = x32.to(torch.bfloat16)
        row = {"block": name, "rows": h, "k": k, "stride": s}
        with torch.no_grad():
            row["whole_ms"] = time_ms(lambda: mbconv_fused(x, *weights, **kw), graph=True)
            for i, win in enumerate(conv_windows(h, 2, k, s)):
                xw = x[:, win.lo:win.hi].contiguous()

                def band(xw=xw, win=win):
                    y = mbconv_fused(xw, *weights, **kw)
                    return y[:, win.first:win.first + win.count].contiguous()
                row[f"band{i}_ms"] = time_ms(band, graph=True)
                row[f"band{i}_window_rows"] = win.hi - win.lo
        rows.append(row)
    whole = sum(r["whole_ms"] for r in rows)
    return {"blocks": rows, "whole_ms": whole,
            **{f"band{i}_ms": sum(r[f"band{i}_ms"] for r in rows) for i in range(2)},
            **{f"band{i}_share": sum(r[f"band{i}_ms"] for r in rows) / whole for i in range(2)}}


def spatial_phase(card: str, timing: bool = True) -> dict:
    """(a) Two gloo ranks on cuda:0 as a 1x2 mesh take one bf16 sync-BN step
    of the production configuration at IMAGE px on BATCH images, each on its
    band of 112 of the 224 rows, against one process's step on the same
    batch, to the bars of ``_held_to_one_ulp``; each rank's launches against
    the band plan, its collectives against ``step_collectives``, its peak
    memory beside one process's, and ms per step (the two ranks share the
    card). (b) The eval forward of the serving phase's weights over the
    same mesh against one process's logits, to the serving phase's bf16
    rule, with the fused MBConv kernel launched on each band. (c) On a
    machine with four cards: NCCL 2x2 on the graph route, the replay bit for
    bit eager. (d) With timing, the MBConv kernel on each band's window
    beside the whole plane (``_band_block_ms``)."""
    import torch.multiprocessing as mp

    work = REPO / "build" / "chip_smoke_spatial"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        images, labels = train_batch()
        _, eval_state = serving_weights(torch.Generator(device="cuda").manual_seed(3))
        torch.save(eval_state, work / "eval_state.pt")
        mp.start_processes(spatial_rank, args=(2, str(work / "rendezvous"), str(work)),
                           nprocs=2, start_method="spawn")
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
        nccl = None
        if torch.cuda.device_count() >= 4:
            mp.start_processes(spatial_nccl_rank, args=(4, str(work / "rdv4"), str(work)),
                               nprocs=4, start_method="spawn")
            nccl = [torch.load(work / f"nccl{r}.pt", weights_only=False) for r in range(4)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card}
    # (a) against one process on the whole batch, and its one-ulp move.
    base = memory_base(torch.device("cuda"))
    ref = _first_step("eager", images, labels)
    one_peak = (torch.cuda.max_memory_allocated() - base[0]) / 1e9
    moved = _first_step("eager", one_ulp(images), labels)
    model, state, step = _train_setup(torch.bfloat16, "kernel", step_route="eager")
    step(state, images, labels)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SPATIAL_TIMED):
        state, _m = step(state, images, labels)
    end.record()
    end.synchronize()
    one_ms = start.elapsed_time(end) / SPATIAL_TIMED
    del model, state, step
    a = ranks[0]["train"]
    replicated = all(r["train"]["loss"] == a["loss"] and all(
        torch.equal(a[f][n], r["train"][f][n]) for f in ("params", "stats") for n in a[f])
        for r in ranks[1:])
    cmp = _held_to_one_ulp(a, ref, moved, "the 1x2 spatial step")
    out["train"] = {**cmp, "ranks_bitwise_equal": replicated, "route": a["route"],
                    "band_rows": [r["train"]["band_rows"] for r in ranks],
                    "launches": [r["train"]["launches"] for r in ranks],
                    "launches_predicted": [r["train"]["expected"]["train"] for r in ranks],
                    "collectives": [r["train"]["collectives"] for r in ranks],
                    "collectives_predicted": [r["train"]["collectives_predicted"] for r in ranks],
                    "peak_gb_by_rank": [r["train"]["peak_gb"] for r in ranks],
                    "peak_gb_one_process": one_peak,
                    "ms_per_step_by_rank": [r["train"]["ms_per_step"] for r in ranks],
                    "ms_per_step_one_process": one_ms}
    log(f"[spatial] (a) 1x2 mesh, two gloo ranks on cuda:0, one bf16 step vs one process: "
        f"{json.dumps(out['train'])} on {card}")
    if not replicated:
        raise RuntimeError("the ranks of the 1x2 step ended in different states")
    if a["route"] != "eager":
        raise RuntimeError(f"the gloo 1x2 step took the {a['route']} route")
    if out["train"]["launches"] != out["train"]["launches_predicted"]:
        raise RuntimeError(f"launches {out['train']['launches']}, by the band plan "
                           f"{out['train']['launches_predicted']}")
    if out["train"]["collectives"] != out["train"]["collectives_predicted"]:
        raise RuntimeError(f"collectives {out['train']['collectives']}, predicted "
                           f"{out['train']['collectives_predicted']}")
    # (b) the eval forward against one process's logits.
    served = create_model("mnasnet1_0", dtype=torch.bfloat16, dw_impl="kernel", seed=0)
    served.load_state_dict(eval_state)
    ref_logits = make_predict_fn(served)(images).cpu()
    ev = ranks[0]["eval"]["logits"]
    out["eval"] = {
        "launches": [r["eval"]["launches"] for r in ranks],
        "launches_predicted": [r["train"]["expected"]["eval"] for r in ranks],
        "ranks_bitwise_equal": all(torch.equal(r["eval"]["logits"], ev) for r in ranks),
        "max_abs_diff": float((ev - ref_logits).abs().max()),
        "tol": 0.25 * float(ref_logits.abs().max()),
        "rel_rms_diff": float((ev - ref_logits).norm() / ref_logits.norm()),
        "top1_agreement": float((ev.argmax(-1) == ref_logits.argmax(-1)).float().mean())}
    log(f"[spatial] (b) 1x2 eval forward vs one process: {json.dumps(out['eval'])}")
    if out["eval"]["launches"] != out["eval"]["launches_predicted"]:
        raise RuntimeError(f"eval launches {out['eval']['launches']}, by the band plan "
                           f"{out['eval']['launches_predicted']}")
    if ev.shape != (BATCH, 1000) or not torch.isfinite(ev).all() \
            or not out["eval"]["ranks_bitwise_equal"] \
            or out["eval"]["max_abs_diff"] > out["eval"]["tol"] \
            or out["eval"]["top1_agreement"] < 0.5:
        raise RuntimeError(f"the 1x2 eval forward disagrees with one process: {out['eval']}")
    # (c) four cards.
    if nccl is not None:
        out["nccl_2x2"] = {"bitwise": [r["bitwise"] for r in nccl],
                           "replays": [r["replays"] for r in nccl],
                           "losses": nccl[0]["losses"]}
        log(f"[spatial] (c) 2x2 mesh over NCCL, graph route vs eager over "
            f"{SPATIAL_BITWISE_STEPS} steps: {json.dumps(out['nccl_2x2'])}")
        if not all(all(r["bitwise"].values()) for r in nccl) \
                or any(r["replays"] != SPATIAL_BITWISE_STEPS - 1 for r in nccl):
            raise RuntimeError(f"the 2x2 graph route differs from eager: {out['nccl_2x2']}")
    if timing:
        out["mbconv_on_bands"] = _band_block_ms()
        log(f"[spatial] (d) MBConv kernel on each band's window vs the whole plane, bf16 "
            f"bs{BATCH}, device ms: {json.dumps(out['mbconv_on_bands'])} on {card}")
    return out


def deadrank_argv(world: int, workers: int) -> list:
    """The deadrank phase's train CLI: the production configuration,
    ``DEADRANK_STEPS`` synthetic steps of ``BATCH`` images a rank an epoch
    (global batch ``BATCH * world``), the kernel route."""
    return ["--synthetic", "--synthetic-size", str(DEADRANK_STEPS * BATCH * world),
            "--batch-size", str(BATCH * world), "--epochs", str(DEADRANK_EPOCHS),
            "--fused-kernels", "kernel", "--dtype", "bfloat16", "--workers", str(workers),
            "--print-freq", "1", "--seed", "0"]


def _killed(what: str, res: dict, bound_s: float, card: str) -> dict:
    rc, latency = res["survivor_exit_code"], res["detection_latency_s"]
    log(f"[deadrank] {what}: the survivor exited {rc} {latency:.1f} s after rank 1's "
        f"SIGKILL (bound {bound_s:.0f} s), on {card}")
    log(f"[deadrank] {what}: the survivor's last line: {res['survivor_last_line']}")
    if rc in (0, None) or latency >= bound_s:
        raise RuntimeError(f"{what}: the survivor of a SIGKILLed peer exited {rc} after "
                           f"{latency:.1f} s; expected non-zero within {bound_s:.0f} s:\n"
                           f"{Path(res['log']).read_text(errors='replace')[-4000:]}")
    return {"survivor_exit_code": rc, "detection_latency_s": latency,
            "bound_s": bound_s, "survivor_last_line": res["survivor_last_line"]}


def deadrank_phase(card: str) -> dict:
    """(a) two gloo ranks of the train CLI on cuda:0 (eager: gloo cannot be
    captured), rank 1 SIGKILLed mid-epoch 1, the survivor
    out within ``DEADRANK_GLOO_BOUND_S``; (b) one process ``--resume``s that
    checkpoint in this process, on the default (graph) route, counted; (c)
    with two or more cards, two NCCL ranks on the graph route, the survivor
    out within ``DIST_TIMEOUT_S + 60`` s."""
    workers = max(1, min((os.cpu_count() or 1) // 2, 8))
    work = REPO / "build" / "chip_smoke_deadrank"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out: dict = {"dist_timeout_s": dist_timeout()}
    try:
        run = str(work / "gloo")
        trigger = re.compile(rf"Epoch: \[1\]\[\s*{DEADRANK_KILL_STEP}/")
        res = deadrank_probe.kill_run(deadrank_argv(2, workers), run, work, device="cuda:0",
                                      backend="gloo", bound_s=DEADRANK_GLOO_BOUND_S,
                                      start_s=DEADRANK_START_S, trigger=trigger)
        out["gloo_one_card"] = _killed("(a) gloo, two ranks on cuda:0", res,
                                       DEADRANK_GLOO_BOUND_S, card)

        calls: list = []
        for fn in COUNTERS.values():  # the main path: counts set to 0 just before
            fn.launches = 0
        with recorded_calls(calls):
            text = run_cli([*deadrank_argv(1, workers), "--output-dir", run, "--resume", run])
        torch.cuda.synchronize()
        launches = counts()
        train = [c for c in calls if c["kind"] == "train_epoch"]
        counted = sum(c["counted_steps"] for c in train)
        step_launches = {k: sum(c["launches"][k] for c in train) for k in launches}
        res = {"launches": launches, "train_launches": step_launches, "counted_steps": counted,
               "routes": sorted({c["route"] for c in train}),
               "final_step": train[-1]["steps"], "epochs": len(train)}
        log(f"[deadrank] (b) one process --resume on the {res['routes']} route: {res}")
        if "=> resumed from epoch 0" not in text or len(train) != DEADRANK_EPOCHS - 1:
            raise RuntimeError("(b) the resume did not run epochs 1.. from epoch 0's checkpoint")
        if res["routes"] != [TRAIN_ROUTE] or step_launches != _scaled(LAUNCHES_PER_STEP, counted) \
                or not all(launches[k] for k, v in LAUNCHES_PER_STEP.items() if v):
            raise RuntimeError(f"(b) the resumed run: {res}; expected the {TRAIN_ROUTE} route "
                               f"and {LAUNCHES_PER_STEP} per counted step")
        out["resume_one_process"] = res

        if torch.cuda.device_count() >= 2:
            bound = dist_timeout() + 60
            res = deadrank_probe.kill_run(deadrank_argv(2, workers), str(work / "nccl"), work,
                                          device="cuda", bound_s=bound,
                                          start_s=DEADRANK_START_S, trigger=trigger)
            out["nccl_graph_two_cards"] = _killed(
                f"(c) NCCL on the {TRAIN_ROUTE} route, two cards", res, bound, card)
        else:
            log("[deadrank] (c) NCCL on the graph route: not run, it needs two cards "
                "(NCCL refuses two ranks on one card)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def trainer_phase(timing: bool, card: str, fixed_batch: dict | None) -> dict:
    workers = min(os.cpu_count() or 1, 16)
    decoder = ("native-fast" if native_decoder.available()
               else f"PIL: native decoder unavailable ({native_decoder.unavailable_reason})")
    log(f"[trainer] JPEG decoder: {decoder}; {workers} workers, {os.cpu_count()} CPUs")
    work = REPO / "build" / "chip_smoke_trainer"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        out = {"decoder": decoder, **folder_run(work, workers)}
        out["folder_run_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["preempt"] = preempt_runs(work, workers)
        out["preempt_s"] = time.perf_counter() - t0
        if timing:
            out["throughput"] = throughput(work, workers, card)
            out["throughput"]["fixed_batch_images_per_s"] = (fixed_batch or {}).get(
                "kernel_route_images_per_s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def smoke_worker(out: Path, argv: list) -> int:
    """One process of the train smoke (``chip_smoke.py --smoke-worker OUT
    ARGV``) with this script's backend flags; its exit code, launches and
    recorded calls go to ``OUT``."""
    faulthandler.dump_traceback_later(SMOKE_WORKER_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    calls: list = []
    for fn in COUNTERS.values():  # the main path: counts set to 0 just before
        fn.launches = 0
    t0 = time.perf_counter()
    with recorded_calls(calls):
        rc = train_smoke.main(argv)
    torch.cuda.synchronize()
    out.write_text(json.dumps({"rc": rc, "launches": counts(), "calls": calls,
                               "main_s": time.perf_counter() - t0}))
    faulthandler.cancel_dump_traceback_later()
    return rc


def _smoke_run(work: Path, tag: str, extra: list) -> subprocess.Popen:
    with open(work / f"{tag}.log", "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--smoke-worker",
             str(work / f"{tag}.rec"), *SMOKE_ARGV, "--json", str(work / f"{tag}.json"), *extra],
            cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT)
    proc.started = time.perf_counter()
    return proc


def _smoke_wait(work: Path, tag: str, proc: subprocess.Popen) -> dict:
    try:
        rc = proc.wait(timeout=SMOKE_WORKER_S + 30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rec = work / f"{tag}.rec"
    if not rec.exists():
        raise RuntimeError(f"smoke {tag}: exited {rc} with no record:\n"
                           f"{(work / f'{tag}.log').read_text()[-3000:]}")
    out = json.loads(rec.read_text())
    out["process_s"] = time.perf_counter() - proc.started
    if out["rc"] != rc:
        raise RuntimeError(f"smoke {tag}: the process exited {rc}, main returned {out['rc']}")
    rec.unlink()  # a rerun of this tag writes its own
    return out


def smoke_start() -> dict:
    """The smoke phase's first two processes, the straight run and the first
    chunk, started side by side in the background. A full run starts them
    before the deadrank phase, which reads no clock but its survivors'
    bounds, and :func:`smoke_phase` waits for them after it."""
    shutil.rmtree(SMOKE_WORK, ignore_errors=True)
    SMOKE_WORK.mkdir(parents=True)
    return {"t0": time.perf_counter(), "procs": {
        "straight": _smoke_run(SMOKE_WORK, "straight",
                               ["--state-file", str(SMOKE_WORK / "straight.pt")]),
        "chunk1": _smoke_run(SMOKE_WORK, "chunk1", ["--state-file",
                                                     str(SMOKE_WORK / "chunked.pt"),
                                                     "--chunk-epochs", "1"])}}


def smoke_stop(started: dict) -> None:
    """Kill the smoke processes still running."""
    for p in started["procs"].values():
        if p.poll() is None:
            p.kill()
            p.wait()


def smoke_phase(card: str, started: dict | None = None) -> dict:
    """The train smoke straight and chunked, then bn_forensics on its state
    (see the module's docstring, 9b); ``started``: :func:`smoke_start`'s
    processes, else they are started here."""
    started = started or smoke_start()
    work, t0 = SMOKE_WORK, started["t0"]
    try:
        straight, chunked = work / "straight.pt", work / "chunked.pt"
        recs = {tag: _smoke_wait(work, tag, p) for tag, p in started["procs"].items()}
        second = _smoke_run(work, "chunk2", ["--state-file", str(chunked), "--chunk-epochs", "1"])
        # The forensics of the straight state while the second chunk runs.
        t1 = time.perf_counter()
        record, (ema, pooled, within, between) = bn_forensics.forensics(
            str(straight), SMOKE_FORENSICS_BATCHES, torch.device("cuda"), workers=4)
        forensics_s = time.perf_counter() - t1
        recs["chunk2"] = _smoke_wait(work, "chunk2", second)
        runs_s = time.perf_counter() - t0
        rcs = {tag: r["rc"] for tag, r in recs.items()}
        seconds = {tag: {"process": r["process_s"], "main": r["main_s"],
                         **{kind: sum(c["s"] for c in r["calls"] if c["kind"] == kind)
                            for kind in ("train_epoch", "validate", "recalibrate_bn")}}
                   for tag, r in recs.items()}
        log(f"[smoke] seconds by run: {json.dumps(seconds)}")
        if rcs["chunk1"] != 3 or rcs["chunk2"] != rcs["straight"] or rcs["straight"] not in (0, 1):
            raise RuntimeError(f"smoke: exit codes {rcs}; expected 3, then the straight run's")

        rec = recs["straight"]
        train = [c for c in rec["calls"] if c["kind"] == "train_epoch"]
        counted = sum(c["counted_steps"] for c in train)
        step_launches = {k: sum(c["launches"][k] for c in train) for k in rec["launches"]}
        val_mbconv = sum(c["launches"]["mbconv_block"] for c in rec["calls"]
                         if c["kind"] == "validate")
        launches = rec["launches"]
        if sorted({c["route"] for c in train}) != [TRAIN_ROUTE] \
                or step_launches != _scaled(LAUNCHES_PER_TWO_PASS_STEP, counted) \
                or not val_mbconv or not all(launches.values()):
            raise RuntimeError(f"smoke: the straight run's routes {[c['route'] for c in train]}, "
                               f"{step_launches} over {counted} counted steps, launches "
                               f"{launches}; expected the {TRAIN_ROUTE} route, "
                               f"{LAUNCHES_PER_TWO_PASS_STEP} a step (--deterministic: "
                               "two_pass) and every kernel launched")

        a, b = (train_smoke.load_state(str(p)) for p in (chunked, straight))
        parts = ("model", "optimizer", "train_state", "curve", "next_epoch", "config_key")
        state_diff = multihost.bitwise_diff({k: a[k] for k in parts}, {k: b[k] for k in parts})
        ja, jb = (json.loads((work / f"{t}.json").read_text()) for t in ("chunk2", "straight"))
        bookkeeping = ("state_file", "chunk_epochs")
        for j in (ja, jb):
            j.pop("wall_seconds")
            j["config"] = {k: v for k, v in j["config"].items() if k not in bookkeeping}
        if state_diff or ja != jb:
            raise RuntimeError(f"smoke: the chunked run differs from the straight one: state "
                               f"{state_diff[:10]}, curves equal: {ja == jb}")

        bns = sum(isinstance(m, BatchNorm) for m in create_model(
            "mnasnet0_35", device="cpu", num_classes=10).modules())
        worst = 0.0
        for name, var in pooled.items():
            if name.endswith("running_var"):
                total = within[name] + between[name[:-len("var")] + "mean"]
                worst = max(worst, float(((var - total).abs() / total.abs().clamp_min(
                    torch.finfo(torch.float32).tiny)).max()))
        if record["summary"]["sites"] != bns or worst > 2.0 ** -22 \
                or set(record["controls_val_top1"]) != {
                    "ema_mean_ema_var", "pooled_mean_pooled_var", "pooled_mean_ema_var",
                    "ema_mean_pooled_var"} or record["nvidia_smi"] != card:
            raise RuntimeError(f"smoke: forensics {record['summary']}, {bns} BatchNorms, "
                               f"pooled - (within + between) up to {worst:.3g} relative, "
                               f"controls {sorted(record['controls_val_top1'])}")
        curve = jb["curve"]
        return {"s": time.perf_counter() - t0, "runs_s": runs_s, "forensics_s": forensics_s,
                "seconds_by_run": seconds,
                "exit_codes": rcs, "launches": launches, "train_launches": step_launches,
                "counted_steps": counted, "routes": sorted({c["route"] for c in train}),
                "chunked_equals_straight": True,
                "final_row": {k: curve[-1].get(k) for k in (
                    "step", "val_top1", "val_top1_raw", "val_top1_recal", "train_top1",
                    "train_top1_evalmode", "bn_init_retention")},
                "forensics": {"summary": record["summary"],
                              "pooled_minus_parts_max_rel": worst,
                              "controls_val_top1": record["controls_val_top1"]}}
    finally:
        smoke_stop(started)
        shutil.rmtree(work, ignore_errors=True)


# The tools phase: each tool's reduced drive (tool, record name, argv) and
# the keys its record must hold beside utils/card.py:card_info's.
TOOL_RUNS = (
    (memory_probe, "memory_probe", ["--batch-sizes", "256", "--accums", "1,2", "--repeats", "2",
                                    "--target-ms", "100"]),
    (bench_latency, "bench_latency", ["--batches", "1,128", "--routes", "graph", "--repeats",
                                      "2", "--target-ms", "50"]),
    (export_latency, "export_latency", ["--batches", "1,128", "--routes", "graph",
                                        "--repeats", "2", "--target-ms", "50"]),
    (e2e_infer, "e2e_infer", ["--n-images", "512", "--workers", "1", "--decoders", "pil",
                              "--repeats", "1"]),
    (sweep_grid, "sweep_grid_0_35", ["--alphas", "0.35", "--sizes", "96", "--repeats", "2",
                                     "--target-ms", "50"]),
    (sweep_grid, "sweep_grid_1_4", ["--alphas", "1.4", "--sizes", "224", "--repeats", "2",
                                    "--target-ms", "50"]),
)
TOOL_KEYS = {
    "memory_probe": {"arch", "image_size", "route", "argument_bytes", "rows", "auto_rule"},
    "bench_latency": {"arch", "image_size", "table", "kernel_wins_at_batches",
                      "route_table_disagrees_at"},
    "export_latency": {"arch", "image_size", "artifact", "rows", "by_batch",
                       "route_table_disagrees_at"},
    "e2e_infer": {"config", "native_decoder_available", "device_only_ips", "table", "best",
                  "native_fast_vs_pil_e2e", "conclusion"},
    "sweep_grid": {"batch_size", "route", "rows", "kernel_slower_than_torch_at"},
}
SERVING_LAUNCHES = {"dw_conv_bn_act": 1, "mbconv_block": 16}
NO_SERVING_LAUNCHES = {"dw_conv_bn_act": 0, "mbconv_block": 0}


def tools_phase(card: str) -> dict:
    """Each measurement tool's ``main(argv)`` at a reduced size, its record
    checked: the keys, the card, and the launches its rows count."""
    work = Path(tempfile.mkdtemp(prefix="tools_", dir=REPO / "build"))
    out: dict = {}
    try:
        for tool, name, argv in TOOL_RUNS:
            t0 = time.perf_counter()
            path = work / f"{name}.json"
            if tool.main(["--out", str(path), *argv]) != 0:
                raise RuntimeError(f"{name} exited non-zero")
            rec = json.loads(path.read_text())
            kind = rec["tool"]
            missing = (TOOL_KEYS[kind] | {"card", "power_limit", "nvidia_smi", "torch",
                                          "cuda"}) - set(rec)
            if missing or rec["card"] != torch.cuda.get_device_name(0) \
                    or rec["nvidia_smi"] != card:
                raise RuntimeError(f"{name}: record without {sorted(missing)} or another "
                                   f"card: {rec.get('card')}, {rec.get('nvidia_smi')}")
            out[name] = {"s": time.perf_counter() - t0, **check_tool_record(kind, rec)}
            log(f"[tools] {name}: {json.dumps(out[name])}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def check_tool_record(kind: str, rec: dict) -> dict:
    """What the phase holds each tool's record to; returns what it read."""
    if kind == "memory_probe":
        rows = {r["grad_accum"]: r for r in rec["rows"]}
        for k, row in rows.items():
            want = {"dw_conv_bn_act": 17 * k, "mbconv_block": 0, "bn_bwd_reduce": 35 * k,
                    "bn_bwd_dx": 35 * k, "bn_fwd_stats": 35 * k, "bn_relu_apply": 35 * k}
            if row["oom"] or row["launches_per_step"] != want or not row["peak_allocated_gb"]:
                raise RuntimeError(f"memory_probe K={k}: {row}")
        if rows[2]["saved_activation_bytes"] > 0.55 * rows[1]["saved_activation_bytes"]:
            raise RuntimeError(f"memory_probe: K=2 saves {rows[2]['saved_activation_bytes']} "
                               f"bytes against K=1's {rows[1]['saved_activation_bytes']}")
        return {k: {key: rows[k][key] for key in ("ms_per_step", "peak_allocated_gb",
                                                   "saved_activation_mib")} for k in rows}
    if kind == "bench_latency":
        for row in rec["table"]:
            if row["launches_per_forward"] != {"kernel": SERVING_LAUNCHES,
                                               "torch": NO_SERVING_LAUNCHES} \
                    or not row["kernel_graph_ms"] or not row["torch_graph_ms"]:
                raise RuntimeError(f"bench_latency bs{row['batch']}: {row}")
        return {r["batch"]: [r["kernel_graph_ms"], r["torch_graph_ms"]] for r in rec["table"]}
    if kind == "export_latency":
        for summary in rec["by_batch"]:
            if not summary["eager_bitwise"] \
                    or summary["artifact_launches_per_call"] != SERVING_LAUNCHES:
                raise RuntimeError(f"export_latency: {summary}")
        if not all(r["live_ms"] and r["artifact_ms"] for r in rec["rows"]):
            raise RuntimeError(f"export_latency: untimed rows {rec['rows']}")
        return {r["batch"]: r["artifact_vs_live_pct"] for r in rec["rows"]}
    if kind == "e2e_infer":
        (row,) = rec["table"]
        if not rec["device_only_ips"] or not row["e2e_ips"] or row["decoder"] != "pil":
            raise RuntimeError(f"e2e_infer: {rec}")
        return {"device_only_ips": rec["device_only_ips"], "e2e_ips": row["e2e_ips"]}
    (row,) = rec["rows"]
    if row["refused"] or row["fused_mbconv_blocks"] != 16 or row["dw_launches"] != 1 \
            or row["launches_per_forward"]["torch"] != NO_SERVING_LAUNCHES \
            or not row["infer_kernel_ips"] or not row["infer_torch_ips"]:
        raise RuntimeError(f"sweep_grid: {row}")
    return {"kernel_ips": row["infer_kernel_ips"], "torch_ips": row["infer_torch_ips"]}


BN_KINDS = {"bn_bwd_reduce": "reduce", "bn_bwd_dx": "dx", "bn_fwd_stats": "stats",
            "bn_relu_apply": "apply"}


def _bn_entry(name, rows, serving_free_launches, replaces):
    bf = [r for r in rows if r["dtype"] == "bfloat16"]
    kind = BN_KINDS[name]

    def total(key):
        return sum(r[key] for r in bf) if all(key in r for r in bf) else None

    return {"name": name, "route": "cuda", "source": "mnasnet_tpu_torch/csrc/bn_bwd.cu",
            "replaces": replaces, "launches": serving_free_launches,
            "max_abs_err": max(r[f"{kind}_max_abs_err"] for r in rows),
            "ms": total(f"{kind}_ms"), "host_ms": total(f"{kind}_host_ms"),
            "device_ms": total(f"{kind}_device_ms"), "plain_ms": total(f"{kind}_plain_ms"),
            "bound_ms": total(f"{kind}_bound_ms"),
            "bound_by": "bytes" if all(r[f"{kind}_bound_by"] == "bytes" for r in bf)
            else "operations",
            "library_ms": total(f"{kind}_library_ms"),
            "library_device_ms": total(f"{kind}_library_device_ms"),
            "torch_route_region_ms": total("torch_route_ms"),
            "plain_forward_ms": total("fwd_plain_ms"),
            "plain_forward_device_ms": total("fwd_plain_device_ms"),
            "region_forward_device_ms": total("fwd_region_device_ms"),
            "summed_over": f"{len(bf)} regions of one training step, bf16"}


def kernels_line(dw_rows, dw_step, mb_rows, serving, serve, bn_rows, train, trainer,
                 dist, knobs, deadrank, smoke, spatial) -> dict:
    sep = next(r for r in dw_rows if r["shape"] == "112x112x32 k3 s1" and r["dtype"] == "bfloat16")
    mb = [r for r in mb_rows if r["dtype"] == "bfloat16"]

    def total(key):
        return sum(r[key] for r in mb) if all(key in r for r in mb) else None

    by_bytes = sum(r["bound_ms"] for r in mb if r["bound_by"] == "bytes")
    paths = {"serving": serving["launches"], "artifact": serve["artifact"]["launches"],
             "artifact_routes": serve["routes_launches"], "train": train["launches"],
             "trainer": trainer["launches"], "dist_torchrun": dist["nccl"]["launches"],
             "dist_ranks_rank0": dist["ranks"]["launches"], "knobs_remat": knobs["launches"],
             "deadrank_resume": deadrank["resume_one_process"]["launches"],
             "smoke": smoke["launches"], "spatial_train_rank0": spatial["train"]["launches"][0],
             "spatial_eval_rank0": spatial["eval"]["launches"][0]}

    def by_path(name):
        return {p: launches.get(name, 0) for p, launches in paths.items()}

    def launches(name):
        return sum(by_path(name).values())

    # The training sums cover the launches one step made in the train phase
    # (a counted step: a graph replay launches without the wrappers).
    dw_per_step = by_path("dw_conv_bn_act")["train"] / train["counted_steps"]
    if dw_step and dw_step["summed_over"] != dw_per_step:
        raise RuntimeError(f"the dw training sums cover {dw_step['summed_over']} launches, "
                           f"a step made {dw_per_step}")
    bn = [_bn_entry(name, bn_rows, launches(name), f"mnasnet_tpu/ops/pallas/bn_bwd.py:{line}")
          for name, line in (("bn_bwd_reduce", 57), ("bn_bwd_dx", 86))]
    # The forward's kernels replace no Pallas kernel: the reference's region
    # forward is plain JAX (csrc/bn_bwd.cu's source note).
    bn += [_bn_entry(name, bn_rows, launches(name), None)
           for name in ("bn_fwd_stats", "bn_relu_apply")]
    for e in bn:
        e["launches_by_path"] = by_path(e["name"])
    return {"kernels": [
        {"name": "dw_conv_bn_act", "route": "cuda", "source": "mnasnet_tpu_torch/csrc/dw_conv.cu",
         "replaces": "mnasnet_tpu/ops/pallas/dw_conv.py:56",
         "also_replaces": "mnasnet_tpu/ops/pallas/dw_conv.py:96",
         "launches": launches("dw_conv_bn_act"), "launches_by_path": by_path("dw_conv_bn_act"),
         "max_abs_err": sep["max_abs_err"], "ms": sep.get("ms"), "host_ms": sep.get("host_ms"),
         "launch_host_ms": sep.get("launch_host_ms"),
         "plain_ms": sep.get("plain_ms"), "bound_ms": sep["bound_ms"],
         "bound_by": sep["bound_by"], "library_ms": sep.get("library_ms"),
         "measured_at": "112x112x32 k3 s1, the serving path's one launch",
         "train_step_launches": dw_per_step,
         **{f"train_step_{key}": dw_step.get(key) for key in DW_SUMS},
         # The 13 stride-1 launches (_dw_s1_kernel's) and the 4 stride-2 ones.
         **{f"train_step_s{st}_{key}": dw_step.get(f"s{st}", {}).get(key)
            for st in (1, 2) for key in ("summed_over", *DW_SUMS)},
         "shapes": dw_rows},
        {"name": "mbconv_block", "route": "cuda", "source": "mnasnet_tpu_torch/csrc/mbconv.cu",
         "replaces": "mnasnet_tpu/ops/pallas/mbconv.py:58",
         "launches": launches("mbconv_block"), "launches_by_path": by_path("mbconv_block"),
         "max_abs_err": max(r["max_abs_err"] for r in mb), "ms": total("ms"),
         "host_ms": total("host_ms"), "launch_host_ms": total("launch_host_ms"),
         "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
         "bound_by": "bytes" if by_bytes * 2 >= total("bound_ms") else "operations",
         "library_ms": None, "torch_route_ms": total("torch_route_ms"),
         "shapes": mb_rows},
        *bn,
    ]}


# Background jobs: the checks that spend their time in Inductor's compiler
# or in processes of their own, and time nothing beside other work (the
# compile route's step is timed in its job after ``farm_go``), each in a
# process of its own (``chip_smoke.py --farm-job NAME OUT``, in a
# session of its own so that its children end with it). A full run starts
# them all once the kernels are timed, takes its own checks that run no
# timing window beside them (serve, train, knobs, deadrank, smoke), waits
# for them, and only then times the routes and runs the rest: no timing
# window runs beside a job. A single phase starts its own jobs.
FARM_WORK = REPO / "build" / "chip_smoke_farm"
FARM_JOB_S = 900
# Inductor's compile workers a job may start (the default is one a core):
# three compiling jobs share the host with this process and the others.
FARM_COMPILE_THREADS = "4"
# The jobs' niceness: this process's own checks, which every timing window
# waits for too, take the host's cores first.
FARM_NICE = 10
FARM_JOBS = {
    "train_compile": lambda: compile_first_step(remat=False),
    "remat_compile": lambda: compile_first_step(remat=True),
    "knob_tests": knob_gpu_tests,
    "serve_cache": serve_cache,
    "dist_ranks": dist_ranks,
    "dist_dryrun": dist_dryrun,
}
_farm: dict = {}


def farm_job(name: str, out: Path) -> int:
    """One background job, in the process ``farm_start`` started: its record
    goes to ``out``; a job past ``FARM_JOB_S`` prints its stacks and exits."""
    faulthandler.dump_traceback_later(FARM_JOB_S, exit=True)
    os.nice(FARM_NICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    record = FARM_JOBS[name]()
    log(f"[farm] {name} done in {time.perf_counter() - t0:.1f} s")
    out.write_text(json.dumps(record))
    faulthandler.cancel_dump_traceback_later()
    return 0


def farm_start(*names: str) -> None:
    """Start each named job that is not running or done."""
    FARM_WORK.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "TORCHINDUCTOR_COMPILE_THREADS": FARM_COMPILE_THREADS}
    for name in names:
        if name in _farm:
            continue
        for suffix in (".json", ".go"):
            (FARM_WORK / f"{name}{suffix}").unlink(missing_ok=True)
        with open(FARM_WORK / f"{name}.log", "w") as f:
            _farm[name] = subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--farm-job", name,
                 str(FARM_WORK / f"{name}.json")],
                cwd=REPO, stdout=f, stderr=subprocess.STDOUT, env=env, start_new_session=True)
        _farm[name].started = time.perf_counter()


def farm_go(name: str, timing: bool) -> None:
    """Tell the job ``name``, which waits for it, that nothing else runs:
    time its step (with ``timing``) or end."""
    (FARM_WORK / f"{name}.go").write_text("1" if timing else "0")


def _farm_wait_go(name: str) -> bool:
    """In a job: wait for :func:`farm_go`; whether to time."""
    go = FARM_WORK / f"{name}.go"
    while not go.exists():
        time.sleep(0.2)
    return go.read_text() == "1"


def _end_session(proc: subprocess.Popen) -> None:
    """Kill ``proc`` and whatever of its session is left."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def farm_result(name: str) -> dict:
    """Wait for the job ``name`` (started now if it was not), print its
    output, and return its record (kept for a second call); raises if it
    failed."""
    farm_start(name)
    proc = _farm[name]
    if hasattr(proc, "record"):
        return proc.record
    try:
        rc = proc.wait(timeout=max(1.0, FARM_JOB_S + 30 - (time.perf_counter() - proc.started)))
    except subprocess.TimeoutExpired:
        rc = "timeout"
    _end_session(proc)
    proc.joined = True
    log(f"[farm] {name}: rc {rc}, joined {time.perf_counter() - proc.started:.1f} s after "
        f"its start:\n{(FARM_WORK / f'{name}.log').read_text(errors='replace')[-20000:]}")
    if rc != 0:
        raise RuntimeError(f"the background job {name} failed (rc {rc})")
    proc.record = json.loads((FARM_WORK / f"{name}.json").read_text())
    return proc.record


def farm_stop() -> None:
    """End every job not yet waited for."""
    for proc in _farm.values():
        if not getattr(proc, "joined", False):
            _end_session(proc)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-timing", action="store_true", help="run the checks only")
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="also write torch.profiler tables of each route's forward and "
                         "train step to DIR")
    ap.add_argument("--only", choices=("all", "train", "kernels", "trainer", "dist", "serve",
                                       "knobs", "deadrank", "tools", "smoke", "spatial", "b4"),
                    default="all",
                    help="'train' runs the bn, dw training and train phases only; "
                         "'kernels' the dw and mbconv phases only; 'trainer' the trainer "
                         "phase only; 'dist' the data-parallel phase only; 'serve' the "
                         "serving deployment phase only; 'knobs' the model knobs phase only; "
                         "'deadrank' the dead-rank phase only; 'tools' the measurement "
                         "tools phase only; 'smoke' the train smoke's phase only; 'spatial' "
                         "the data x spatial mesh phase only; 'b4' the efficientnet_b4 "
                         "phase only")
    if sys.argv[1:2] == ["--dist-worker"]:
        return dist_worker(Path(sys.argv[2]), sys.argv[3:])
    if sys.argv[1:2] == ["--dist-fixed"]:
        return fixed_worker(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--smoke-worker"]:
        return smoke_worker(Path(sys.argv[2]), sys.argv[3:])
    if sys.argv[1:2] == ["--farm-job"]:
        return farm_job(sys.argv[2], Path(sys.argv[3]))
    args = ap.parse_args()
    timing = not args.no_timing
    if args.profile is not None:
        args.profile.mkdir(parents=True, exist_ok=True)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The trainer phase's --deterministic runs need cuBLAS's fixed workspace
    # from the first cuBLAS call of this process on.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = card_line()
    if card is None:
        raise RuntimeError("nvidia-smi is missing: the card's name and power limit are unread")
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(per source: {_build.build_seconds})")

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")
        return result

    try:
        return run_phases(args.only, timing, card, args.profile, phase)
    finally:
        farm_stop()


def run_phases(only: str, timing: bool, card: str, profile_dir: Path | None, phase) -> int:
    """The phases ``--only`` names, in the order of the module's docstring
    (a full run takes the background jobs' results where it waits for them)."""
    if only in ("all", "kernels"):
        dw_rows = phase("dw", dw_phase, timing)
        dw_step = phase("dw-step", dw_train_timing) if timing else {}
        mb_rows = phase("mbconv", mbconv_phase, timing)
    if only == "kernels":
        log(json.dumps({"dw": dw_rows, "dw_step": dw_step, "mbconv": mb_rows}))
        log(card)
        return 0
    if only == "trainer":
        log(json.dumps({"trainer": phase("trainer", trainer_phase, timing, card, None)}))
        log(card)
        return 0
    if only == "dist":
        log(json.dumps({"dist": phase("dist", dist_phase, timing, card, None, profile_dir)}))
        log(card)
        return 0
    if only == "serve":
        serve, held = phase("serve", serve_phase)
        serve["cache"] = farm_result("serve_cache")
        if timing:
            phase("serve-timing", serve_timing, serve, held, card)
        log(json.dumps({"serve": serve}))
        log(card)
        return 0
    if only == "knobs":
        farm_start("remat_compile", "knob_tests")
        knobs = phase("knobs", knobs_phase)
        knobs["remat_compile_vs_eager"] = farm_result("remat_compile")
        knobs["gpu_tests"] = farm_result("knob_tests")
        if timing:
            knobs["timing"] = phase("knob-timing", knob_timing, card)
        log(json.dumps({"knobs": knobs}, default=str))
        log(card)
        return 0
    if only == "deadrank":
        log(json.dumps({"deadrank": phase("deadrank", deadrank_phase, card)}))
        log(card)
        return 0
    if only == "tools":
        log(json.dumps({"tools": phase("tools", tools_phase, card)}))
        log(card)
        return 0
    if only == "smoke":
        log(json.dumps({"smoke": phase("smoke", smoke_phase, card)}))
        log(card)
        return 0
    if only == "spatial":
        log(json.dumps({"spatial": phase("spatial", spatial_phase, card, timing)}))
        log(card)
        return 0
    if only == "b4":
        b4 = phase("b4", b4_phase, timing)
        log(json.dumps({"kernels": b4_kernel_entries(b4)}))
        log(json.dumps({"b4": b4}))
        log(card)
        return 0
    if only == "all":
        serving = phase("serving", serving_phase, timing, card, profile_dir)
    bn_rows = phase("bn", bn_phase, timing)
    dw_train = phase("dw-train", dw_train_phase)
    if only == "all":
        b4 = phase("b4", b4_phase, timing)

    # Nothing is timed from here until the jobs are done; each phase of this
    # process hands its cached device memory back for the jobs'.
    farm_start(*(FARM_JOBS if only == "all" else ("train_compile",)))

    def checks(name, fn, *a):
        result = phase(name, fn, *a)
        torch.cuda.empty_cache()
        return result

    if only == "all":
        serve, held = checks("serve", serve_phase)
    train = checks("train", train_phase)
    if only == "all":
        knobs = checks("knobs", knobs_phase)
        # The smoke phase's first two processes run beside the deadrank phase.
        smoke_runs = smoke_start()
        try:
            deadrank = checks("deadrank", deadrank_phase, card)
        except BaseException:
            smoke_stop(smoke_runs)
            raise
        smoke = checks("smoke", smoke_phase, card, smoke_runs)
        t0 = time.perf_counter()
        jobs = {name: farm_result(name) for name in FARM_JOBS if name != "train_compile"}
        log(f"[farm] waited {time.perf_counter() - t0:.1f} s for the background jobs")
        serve["cache"] = jobs["serve_cache"]
        knobs["remat_compile_vs_eager"] = jobs["remat_compile"]
        knobs["gpu_tests"] = jobs["knob_tests"]
        if timing:
            phase("serve-timing", serve_timing, serve, held, card)
        del held
    # The compile route's step is timed in its job, with nothing else running.
    farm_go("train_compile", timing)
    train["bf16_compile_vs_eager"] = farm_result("train_compile")
    if timing:
        train.update(phase("train-timing", train_timing, card, profile_dir,
                           train["bf16_compile_vs_eager"].pop("timing")))

    if only == "all":
        if timing:
            knobs["timing"] = phase("knob-timing", knob_timing, card)
        trainer = phase("trainer", trainer_phase, timing, card, train)
        dist = phase("dist", dist_phase, timing, card, trainer, profile_dir)
        spatial = phase("spatial", spatial_phase, card, timing)
        tools = phase("tools", tools_phase, card)
        line = kernels_line(dw_rows, dw_step, mb_rows, serving, serve, bn_rows, train, trainer,
                            dist, knobs, deadrank, smoke, spatial)
        line["kernels"] += b4_kernel_entries(b4)
        log(json.dumps(line))
        log(json.dumps({"b4": b4}))
        log(json.dumps({"serving": serving}))
        log(json.dumps({"serve": serve}))
        log(json.dumps({"trainer": trainer}))
        log(json.dumps({"dist": dist}))
        log(json.dumps({"spatial": spatial}))
        log(json.dumps({"deadrank": deadrank}))
        log(json.dumps({"smoke": smoke}))
        log(json.dumps({"tools": tools}))
        log(json.dumps({"knobs": knobs}, default=str))
    log(json.dumps({"train": train, "dw_train": dw_train}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
