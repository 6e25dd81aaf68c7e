"""ImageNet training CLI of the PyTorch port: the root ``train.py``.

    python -m mnasnet_tpu_torch.train DATA_DIR --arch mnasnet1_0 --batch-size 256 ...
    python -m mnasnet_tpu_torch.train --synthetic --arch mnasnet0_5 --image-size 64 ...
    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m mnasnet_tpu_torch.train DATA_DIR --batch-size 1024 ...

The flags, defaults and printed lines are the root ``train.py``'s, plus
``--device`` (default ``cuda``; ``--device cpu`` trains on the CPU with the
kernels' plain versions). ``--fused-kernels`` takes ``auto|kernel|torch``
and the reference's spellings (``pallas`` = ``kernel``, ``xla`` = ``torch``);
it routes both the depthwise convs and the BN+ReLU backward.

Data parallelism: one process per GPU, launched by ``torchrun`` (its
environment is read) or by hand with ``--dist-url URL --world-size W --rank
R`` on each process; ``--batch-size`` is the global batch and each replica
takes ``--batch-size / W`` of it from its shard of the data. Sync-BN is the
default and ``--no-sync-bn`` keeps per-replica statistics. Rank 0 prints and
writes the checkpoints; every rank prints its own decoder-fallback count.
``--compilation-cache DIR`` keeps the compiled routes' caches (Inductor,
Triton) in DIR across runs. The train step runs on the train route
(``utils/routing.py:default_train_route``: ``TRAIN_ROUTE`` on the card,
one process or NCCL replicas under ``torchrun``; eager with ``--device
cpu``, whose replicas are gloo's; the environment variable
``MNASNET_TPU_TORCH_ROUTE=eager|graph|compile`` overrides it, and a route
the replicas cannot take raises), and validation runs each batch size on
the route measured fastest for it.
``--profile-steps`` traces graph replays as it traces eager steps.
``--remat`` recomputes each MBConv block's forward in the backward (the same
step, less activation memory; the checkpoints are the same with and without
it).

A dead or stalled peer: every collective waits at most ``DIST_TIMEOUT_S``
(``parallel/dist.py``; ``MNASNET_TPU_TORCH_DIST_TIMEOUT`` overrides it).
Over gloo the collective raises (at once for a dead peer, at the timeout for
a stalled one) and the rank prints one line to stderr, ``[rank R] <the
collective> failed: <why>; exiting``, aborts the group and exits 1; a
SIGTERM whose stop agreement fails so writes no preemption checkpoint. Over
NCCL the host's deadline (``parallel/dist.py:Deadline``) ends the process
with one line and exit 1 once an eager collective, or a replay of the
step's graph, has not completed within the timeout.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from mnasnet_tpu_torch.ops.depthwise import CLI_IMPLS


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m mnasnet_tpu_torch.train",
                                description="MNASNet ImageNet training (PyTorch port)")
    p.add_argument("data", nargs="?", default=None,
                   help="path to dataset root (train/ and val/ subdirs)")
    p.add_argument("-a", "--arch", default="mnasnet1_0",
                   help="model architecture (mnasnet0_35/0_5/0_75/1_0/1_3/1_4, or any "
                        "mnasnet<int>_<frac> multiplier spelling)")
    p.add_argument("--workers", type=int, default=4, help="data loading worker threads")
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("-b", "--batch-size", type=int, default=256,
                   help="global batch size (one GPU: the batch of each step)")
    p.add_argument("--lr", "--learning-rate", type=float, default=None, dest="lr",
                   help="base LR (default: optimizer-specific)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", "--weight-decay", type=float, default=1e-5, dest="weight_decay")
    p.add_argument("-p", "--print-freq", type=int, default=10)
    p.add_argument("--resume", default="", help="resume from checkpoint dir")
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--pretrained", nargs="?", const="__auto__", default="",
                   help="path to a torchvision-layout checkpoint to load; bare "
                        "--pretrained (reference boolean form) looks for "
                        "$MNASNET_PRETRAINED_DIR/<arch>.pth")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--world-size", type=int, default=-1,
                   help="number of processes; with --dist-url the processes to start the "
                        "group with, else checked against torchrun's (-1: any)")
    p.add_argument("--rank", type=int, default=-1,
                   help="this process's rank; with --dist-url required, else checked "
                        "against torchrun's (-1: any)")
    p.add_argument("--dist-url", default=None,
                   help="rendezvous of the process group (tcp://host:port, file:///path, "
                        "env://) when not launched by torchrun; needs --world-size > 1")
    p.add_argument("--dist-backend", default=None,
                   help="nccl (default on a GPU) or gloo (default on the CPU)")
    p.add_argument("--gpu", type=int, default=None, help="[compat] ignored; see --device")
    p.add_argument("--multiprocessing-distributed", action="store_true",
                   help="[compat] ignored")
    p.add_argument("--optimizer", choices=["sgd", "rmsprop"], default="rmsprop")
    p.add_argument("--lr-schedule", choices=["step", "cosine", "exp", "constant"],
                   default="step")
    p.add_argument("--warmup-epochs", type=float, default=0.0)
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--fused-kernels", choices=sorted(CLI_IMPLS), default="auto",
                   help="route of the depthwise convs and the BN+ReLU backward: the "
                        "CUDA kernels (kernel, or the reference's 'pallas'), plain "
                        "PyTorch (torch, or 'xla'), or auto (kernel on a GPU)")
    p.add_argument("--bn-stats", choices=["one_pass", "two_pass"], default="one_pass",
                   help="BN batch-statistics formulation (two_pass under --deterministic)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise the MBConv blocks: recompute each block's forward "
                        "in the backward (less activation memory, more device time; the "
                        "same step and checkpoints)")
    p.add_argument("--model-ema", type=float, default=0.0, metavar="DECAY",
                   help="keep a weight moving average with this decay and evaluate and "
                        "track best on it (the TF recipe's 0.9999 with the num_updates "
                        "warmup); 0 disables")
    p.add_argument("--grad-accum", type=int, default=0, metavar="K",
                   help="accumulate gradients over K sequential microbatches (one "
                        "optimizer update per --batch-size samples; per-microbatch BN "
                        "statistics; needs --fused-updates). 0 (default) = auto, which "
                        "is the direct step on a GPU")
    p.add_argument("--on-preempt", choices=["save", "ignore"], default="save",
                   help="SIGTERM behavior: 'save' finishes the in-flight step, writes a "
                        "preemption checkpoint and exits cleanly; --resume then continues "
                        "at the exact step. 'ignore' keeps the default kill behavior")
    p.add_argument("--fused-updates", action=argparse.BooleanOptionalAction, default=True,
                   help="fused small-tensor updates (default on): the per-channel "
                        "parameters update as one multi-tensor group and the BN "
                        "running-stat EMA is applied once over all statistics (external "
                        "BN EMA); the same elementwise math")
    p.add_argument("--stem-s2d", action=argparse.BooleanOptionalAction, default=True,
                   help="space-to-depth stem in training (an exact rewrite of the 3x3/s2 "
                        "RGB conv; same checkpoint layout)")
    p.add_argument("--bn-recalibrate", type=int, default=0, metavar="N",
                   help="after training, recompute the BN running stats as exact pooled "
                        "statistics over N train batches with frozen weights (0 = off), "
                        "then re-validate and save under key --epochs")
    p.add_argument("--output-dir", default="./checkpoints")
    p.add_argument("--save-freq-steps", type=int, default=0,
                   help="also checkpoint every N steps (0 = epoch-only)")
    p.add_argument("--mesh-dcn", type=int, default=1,
                   help="nodes (slices) of a multi-node run; must divide the world size and "
                        "needs sync-BN. NCCL reduces within a node before it crosses "
                        "nodes, so it adds no code path")
    p.add_argument("--sync-bn", action=argparse.BooleanOptionalAction, default=True,
                   help="global BN statistics over all replicas (default); --no-sync-bn "
                        "normalises each replica with its own shard's statistics")
    p.add_argument("--scale-lr", action=argparse.BooleanOptionalAction, default=None,
                   help="linear batch-size LR scaling (lr * batch/256); default: applied "
                        "only to the optimizer-default LR, never to an explicit --lr")
    p.add_argument("--deterministic", action="store_true",
                   help="bit-reproducible runs: seed=0 unless --seed given, two-pass BN "
                        "stats; on a GPU also deterministic algorithms (an op without "
                        "one raises), no cuDNN benchmarking or TF32, a fixed cuBLAS "
                        "workspace")
    p.add_argument("--decoder", choices=["pil", "native", "native-fast"],
                   default="native-fast",
                   help="JPEG path: PIL, native fused decoder (strict PIL parity), or "
                        "native with DCT-scaled decode (fastest); native falls back to "
                        "PIL if the C++ build is unavailable")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic FakeData (no dataset required)")
    p.add_argument("--synthetic-size", type=int, default=1024,
                   help="samples per synthetic epoch")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--freeze-backbone", action="store_true",
                   help="train only the classifier head (linear probe): backbone updates "
                        "are zeroed; BN running stats still update in training mode")
    p.add_argument("--profile-steps", default="",
                   help="N:M: torch.profiler trace of train steps N..M (epoch 0)")
    p.add_argument("--tensorboard", default="", help="TensorBoard log dir (empty = off)")
    p.add_argument("--compilation-cache", default=None, metavar="DIR",
                   help="persistent cache of the compiled routes (Inductor's FX graphs, "
                        "Triton's kernels) in DIR; the compile routes of validation and "
                        "of the train step read it (default: "
                        "$MNASNET_TPU_COMPILATION_CACHE, else off)")
    p.add_argument("--device", default="cuda",
                   help="device to train on (default cuda; cpu runs the kernels' plain "
                        "versions)")
    args = p.parse_args(argv)
    # Reference-boolean `--pretrained` placed before the positional makes
    # argparse consume DATA_DIR as the flag's value: a value that is an
    # existing directory (not a weights file) was meant as the dataset root.
    if (args.data is None and args.pretrained and args.pretrained != "__auto__"
            and not args.pretrained.endswith((".pth", ".pth.tar", ".pt", ".npz"))
            and os.path.isdir(args.pretrained)):
        args.data, args.pretrained = args.pretrained, "__auto__"
    if args.deterministic:
        if args.seed is None:
            args.seed = 0
        args.bn_stats = "two_pass"
    return args


def check_topology(args, world: int) -> None:
    """The reference's refusals of a data-parallel layout (``train.py:424-430``)
    at world size ``world``: ``--mesh-dcn`` needs sync-BN and must divide the
    world; ``--grad-accum`` already uses per-microbatch BN statistics and is
    refused with ``--no-sync-bn``; the global batch must split evenly."""
    if args.mesh_dcn < 1:
        raise SystemExit(f"--mesh-dcn {args.mesh_dcn} invalid (>= 1)")
    if args.mesh_dcn > 1 and not args.sync_bn:
        raise SystemExit("--mesh-dcn requires --sync-bn (local BN shards only over the "
                         "replicas of one node)")
    if args.grad_accum > 1 and not args.sync_bn:
        raise SystemExit("--grad-accum already uses per-microbatch BN; drop --no-sync-bn")
    if world % args.mesh_dcn:
        raise SystemExit(f"--mesh-dcn {args.mesh_dcn} does not divide the world size {world}")
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} (the global batch) does not split "
                         f"over {world} processes")


def check_world(args, replicas) -> None:
    """``--world-size`` and ``--rank`` against the process group, as
    ``train.py:310-317`` checks them against JAX's processes."""
    world, rank = (1, 0) if replicas is None else (replicas.world, replicas.rank)
    if args.world_size not in (-1, world):
        raise SystemExit(f"--world-size {args.world_size} != the process group's {world}; "
                         "launch with torchrun, or give every process --dist-url and --rank")
    if args.rank not in (-1, rank):
        raise SystemExit(f"--rank {args.rank} != this process's rank {rank} in the group")


def _check_preempt_meta(pre_dir: str, spe: int) -> None:
    """The preempt checkpoint's key is a global step: divmod by
    steps_per_epoch means something only with the interrupted run's
    steps_per_epoch, which meta.json pins; a mismatched resume is refused. A
    missing or unreadable meta.json skips the check with a warning (the
    checkpoint itself is written atomically)."""
    meta_path = os.path.join(pre_dir, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        saved_spe = meta["steps_per_epoch"]
    except FileNotFoundError:
        return
    except (json.JSONDecodeError, KeyError, OSError, TypeError) as e:
        print(f"WARNING: unreadable {meta_path} ({e!r}) — skipping the steps-per-epoch "
              "consistency check; make sure this resume uses the interrupted run's batch "
              "size and dataset", file=sys.stderr, flush=True)
        return
    if saved_spe != spe:
        raise SystemExit(
            f"preemption checkpoint {pre_dir} was written with steps_per_epoch={saved_spe} "
            f"(global batch {meta.get('global_batch', '?')}); this invocation has "
            f"steps_per_epoch={spe}. Mid-epoch resume needs the same batch size and "
            "dataset — rerun with the original settings.")


def _set_deterministic(device) -> None:
    """What bit-reproducible runs take on a GPU: cuBLAS's fixed workspace
    (read at its first call), deterministic algorithms everywhere (an op
    that has none raises rather than varies), no cuDNN autotuning, and no
    TF32 in cuDNN's convolutions. TF32 (on in PyTorch by default) rounds a
    conv's inputs to 10 mantissa bits in the algorithms cuDNN picks by
    shape, so the stem conv's gradient over two ranks' halves and over the
    whole batch differed by 27% relative RMS on an H100 at random init, and
    by the fp32 rounding's 0.4% without it (``tools/stem_grad_order.py``,
    PERF.md): the reference pins two-pass BN under ``--deterministic`` for
    results that do not depend on the mesh, and this keeps that promise on
    the card."""
    import torch

    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)


def main(argv=None):
    args = parse_args(argv)
    # The layout as declared, before any process joins a group.
    declared = args.world_size if args.world_size > 0 else int(os.environ.get("WORLD_SIZE", 1))
    check_topology(args, declared)

    import torch

    from mnasnet_tpu_torch.models.mnasnet import resolve_device
    from mnasnet_tpu_torch.parallel import close, init_distributed
    from mnasnet_tpu_torch.utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache(args.compilation_cache)
    device = resolve_device(args.device)
    try:
        replicas = init_distributed(args.dist_url, args.world_size, args.rank,
                                    args.dist_backend, device)
    except ValueError as e:  # a layout the flags leave incomplete
        raise SystemExit(str(e)) from e
    prev_deterministic = torch.are_deterministic_algorithms_enabled()
    prev_benchmark = torch.backends.cudnn.benchmark
    prev_tf32 = torch.backends.cudnn.allow_tf32
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    try:
        check_world(args, replicas)
        if replicas is not None:
            check_topology(args, replicas.world)
            device = replicas.device
        if args.deterministic:
            _set_deterministic(device)
        _train(args, device, replicas)
    except Exception as e:
        if replicas is None or replicas.failed is None:
            raise
        # A dead or stalled peer: one line, and a non-zero exit that waits on
        # nothing (close aborts the failed group). A stop asked by SIGTERM
        # whose agreement failed writes no preemption checkpoint.
        print(f"[rank {replicas.rank}] {replicas.failed}; exiting", file=sys.stderr,
              flush=True)
        raise SystemExit(1) from e
    finally:
        torch.use_deterministic_algorithms(prev_deterministic)
        torch.backends.cudnn.benchmark = prev_benchmark
        torch.backends.cudnn.allow_tf32 = prev_tf32
        signal.signal(signal.SIGTERM, prev_sigterm)
        close(replicas)


def build_loaders(args, seed: int, world: int, rank: int, say=print):
    """The train loader (shuffled, augmented, ``drop_last``) and the val
    loader of replica ``rank`` of ``world``: its shard of the data in host
    batches of ``--batch-size / world``."""
    from mnasnet_tpu_torch.data.dataset import ImageFolderDataset, SyntheticDataset
    from mnasnet_tpu_torch.data.pipeline import DataLoader
    from mnasnet_tpu_torch.data.transforms import eval_transform, train_transform

    if args.synthetic:
        train_ds = SyntheticDataset(args.synthetic_size, args.image_size, args.num_classes,
                                    seed=seed)
        val_ds = SyntheticDataset(max(args.synthetic_size // 4, args.batch_size),
                                  args.image_size, args.num_classes, seed=seed + 1)
    else:
        if not args.data:
            raise SystemExit("DATA_DIR required unless --synthetic")
        train_ds = ImageFolderDataset(os.path.join(args.data, "train"))
        val_ds = ImageFolderDataset(os.path.join(args.data, "val"))

    train_bytes_tf = val_bytes_tf = None
    if args.decoder != "pil":
        from mnasnet_tpu_torch.data import native_decoder

        if native_decoder.available():
            fast = args.decoder == "native-fast"

            def train_bytes_tf(data, rng):
                return native_decoder.decode_train(data, args.image_size, rng, fast=fast)

            def val_bytes_tf(data):
                return native_decoder.decode_eval(data, args.image_size, fast=fast)
        else:
            say("warning: native decoder unavailable, using PIL "
                f"({native_decoder.unavailable_reason})", flush=True)

    # --batch-size is the global batch (train.py:362): each replica loads its
    # shard's share of it.
    host_batch = args.batch_size // world
    train_loader = DataLoader(
        train_ds, host_batch,
        lambda img, rng: train_transform(img, args.image_size, rng),
        shuffle=True, drop_last=True, seed=seed, workers=args.workers,
        shard_id=rank, num_shards=world, bytes_transform=train_bytes_tf,
    )
    val_loader = DataLoader(
        val_ds, host_batch, lambda img: eval_transform(img, args.image_size),
        shuffle=False, drop_last=False, seed=seed, workers=args.workers, augment=False,
        shard_id=rank, num_shards=world, bytes_transform=val_bytes_tf,
    )
    return train_loader, val_loader


def _train(args, device, replicas):
    import torch

    from mnasnet_tpu_torch import create_model
    from mnasnet_tpu_torch.parallel import (
        ReplicaMismatch,
        broadcast_seed,
        broadcast_state_,
        gather_int,
        make_mesh,
        use_mesh,
    )
    from mnasnet_tpu_torch.train.checkpoint import CheckpointManager
    from mnasnet_tpu_torch.train.optim import create_optimizer, get_ema_params
    from mnasnet_tpu_torch.train.schedules import make_schedule, scale_lr_for_batch
    from mnasnet_tpu_torch.train.steps import resolve_auto_grad_accum
    from mnasnet_tpu_torch.train.trainer import Trainer, swapped_params

    world, rank = (1, 0) if replicas is None else (replicas.world, replicas.rank)
    is_main = rank == 0
    if replicas is not None:
        # --mesh-dcn lays the ranks out as (dcn, data): the batch shards over
        # both jointly, and every collective stays world-wide.
        use_mesh(replicas, make_mesh(world, dcn=args.mesh_dcn))

    def say(*a, **kw):
        """print on rank 0 only: every replica runs the same run."""
        if is_main:
            print(*a, **kw)

    seed = args.seed if args.seed is not None else int(time.time()) % (2**31)
    # Processes can read different seconds; the shuffle, the augmentation
    # and the dropout masks need one seed everywhere.
    seed = broadcast_seed(seed, replicas)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    impl = CLI_IMPLS[args.fused_kernels]
    model = create_model(
        args.arch, device=device, num_classes=args.num_classes, dtype=dtype, dw_impl=impl,
        bn_bwd=impl, remat=args.remat, bn_stats=args.bn_stats,
        bn_ema="external" if args.fused_updates else "module",
        stem_s2d=args.stem_s2d, seed=seed,
    )

    train_loader, val_loader = build_loaders(args, seed, world, rank, say)

    # ---- optimizer + schedule --------------------------------------------
    steps_per_epoch = train_loader.steps_per_epoch()
    base_lr = args.lr
    if base_lr is None:
        base_lr = 0.1 if args.optimizer == "sgd" else 0.016
        scale = args.scale_lr is not False  # the default LR scales unless --no-scale-lr
    else:
        # An explicit --lr is the literal base LR; it scales only on --scale-lr.
        scale = args.scale_lr is True
    if scale:
        base_lr = scale_lr_for_batch(base_lr, args.batch_size)
    schedule = make_schedule(args.lr_schedule, base_lr, steps_per_epoch, args.epochs,
                             warmup_epochs=args.warmup_epochs)
    frozen_mask = None
    if args.freeze_backbone:
        from mnasnet_tpu_torch.train.optim import backbone_frozen_mask

        frozen_mask = backbone_frozen_mask
        say("=> --freeze-backbone: only the classifier head trains "
            "(BN running stats still update)")
    tx = create_optimizer(
        args.optimizer, schedule, momentum=args.momentum, weight_decay=args.weight_decay,
        fused="small" if args.fused_updates else False,
        model_ema=args.model_ema or None, frozen_mask=frozen_mask,
    )

    writer = None
    if args.tensorboard and is_main:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(args.tensorboard)

    step_tracer = None
    if args.profile_steps and is_main:
        from mnasnet_tpu_torch.utils.profiling import StepTracer, parse_profile_steps

        lo, hi = parse_profile_steps(args.profile_steps)
        step_tracer = StepTracer(os.path.join(args.output_dir, "profile"), lo, hi)

    if args.grad_accum > 1:
        if not args.fused_updates:
            raise SystemExit("--grad-accum requires --fused-updates "
                             "(external BN EMA: one EMA per optimizer update)")
        if train_loader.batch_size % args.grad_accum:
            raise SystemExit(f"the per-process batch {train_loader.batch_size} not divisible "
                             f"by --grad-accum {args.grad_accum}")
    elif args.grad_accum == 0:
        # Auto. The reference accumulates on its TPU, where it measured a
        # microbatch cliff at 128 (MICROBATCH_LIMIT); on an H100 the direct
        # step beat 128-image microbatches at B 256 and 512 (train/steps.py:
        # CUDA_MICROBATCH_LIMIT, H100_MEMORY_PROBE_pr12.json), so CUDA
        # resolves to 1 unless that limit is set.
        args.grad_accum = resolve_auto_grad_accum(
            args.batch_size, world, device.type, sync_bn=args.sync_bn,
            fused_updates=args.fused_updates)
    elif args.grad_accum < 0:
        raise SystemExit(f"--grad-accum {args.grad_accum} invalid (0 = auto, >=1 explicit)")

    trainer = Trainer(
        model, tx, device=device, label_smoothing=args.label_smoothing, compute_dtype=dtype,
        schedule=schedule, print_freq=args.print_freq, writer=writer,
        step_tracer=step_tracer, grad_accum=args.grad_accum, replicas=replicas,
        sync_bn=args.sync_bn,
    )
    # Before the pretrained load, as train.py:460,502-505: the load replaces
    # the weights and BN statistics only, so a model-EMA shadow starts from
    # the init.
    state = trainer.create_state(seed)
    if args.pretrained:
        from mnasnet_tpu_torch.pretrained import load_state_dict_file, load_weights

        if args.pretrained == "__auto__":
            # Reference boolean form: resolve against a local weights directory.
            pdir = os.environ.get("MNASNET_PRETRAINED_DIR", "./pretrained")
            for ext in (".pth", ".pth.tar", ".pt", ".npz"):
                cand = os.path.join(pdir, args.arch + ext)
                if os.path.exists(cand):
                    args.pretrained = cand
                    break
            else:
                raise SystemExit(f"--pretrained: no {args.arch}.pth under {pdir} "
                                 "(set MNASNET_PRETRAINED_DIR or pass an explicit path)")
        try:
            ckpt_classes = load_weights(model, load_state_dict_file(args.pretrained))
        except ValueError as e:
            raise SystemExit(f"--pretrained: {e}")
        if ckpt_classes != args.num_classes:
            say(f"=> checkpoint classifier has {ckpt_classes} classes, model has "
                f"{args.num_classes}: transfer-learning load (backbone from checkpoint, "
                "classifier freshly initialized)")
        say(f"=> loaded pretrained weights from {args.pretrained}")

    # Every replica starts from rank 0's state (a --pretrained file read on
    # each rank, the init from the shared seed).
    broadcast_state_(model, tx, replicas)

    mgr = CheckpointManager(os.path.abspath(args.output_dir), replicas=replicas)
    best_acc1, start_epoch, start_step = 0.0, args.start_epoch, 0
    restored_any = False
    if args.resume:
        rmgr = (mgr if os.path.abspath(args.resume) == os.path.abspath(args.output_dir)
                else CheckpointManager(os.path.abspath(args.resume), replicas=replicas))
        try:
            start_epoch, best_acc1 = rmgr.restore(model, tx, state)
            restored_any = True
        except FileNotFoundError:
            # No epoch checkpoint yet: legal when the run was preempted inside
            # its first epoch (only preempt/ exists); the check below still
            # refuses when preempt/ is missing too.
            pass
        except ReplicaMismatch:
            raise
        except (ValueError, KeyError, RuntimeError) as e:
            raise SystemExit(
                f"--resume: checkpoint structure does not match the current flags "
                f"(arch={args.arch}, optimizer={args.optimizer}, model-ema="
                f"{args.model_ema}, freeze-backbone={args.freeze_backbone}). Re-run with "
                f"the flags the checkpoint was written with. Original error: {e}") from e
        else:
            say(f"=> resumed from epoch {start_epoch - 1} (best acc1 {best_acc1:.3f})")
        # A preemption checkpoint newer than the last completed epoch wins:
        # resume mid-epoch at the exact step (the loader skips the consumed
        # batches without decoding them).
        pre_dir = os.path.join(os.path.abspath(args.resume), "preempt")
        if os.path.isdir(pre_dir):
            spe = train_loader.steps_per_epoch()
            pmgr = CheckpointManager(pre_dir, max_to_keep=1, track_best=False,
                                     replicas=replicas)
            gstep = pmgr.latest_epoch()  # key = next global step to run
            # >= (not >): a preemption before the first step writes key 0.
            # Mid-epoch keys have gstep % spe != 0, so a stale entry from an
            # earlier, already-resumed interruption loses to the epoch
            # checkpoint here.
            if gstep is not None and gstep >= start_epoch * spe:
                _check_preempt_meta(pre_dir, spe)
                _, best_acc1 = pmgr.restore(model, tx, state, epoch=gstep)
                restored_any = True
                start_epoch, start_step = divmod(gstep, spe)
                say(f"=> resumed from preemption checkpoint: epoch {start_epoch} "
                    f"step {start_step} (global step {gstep})")
        if not restored_any:
            raise SystemExit(
                f"--resume {args.resume}: no checkpoint found (neither an epoch checkpoint "
                "nor preempt/) — refusing to silently train from scratch")

    if args.evaluate:
        trainer.validate(state, val_loader)
        return

    if args.on_preempt == "save":
        def _on_sigterm(signum, frame):
            # Event.set and os.write only: print() from a signal handler can
            # hit the buffered stdout's reentrancy guard if the signal lands
            # inside the main thread's own print, and crash the run before
            # the preemption checkpoint it exists to write.
            trainer.request_stop()
            os.write(2, b"=> SIGTERM: finishing the in-flight step, then "
                        b"saving a preemption checkpoint...\n")

        signal.signal(signal.SIGTERM, _on_sigterm)

    step_cb, step_mgr = None, None
    if args.save_freq_steps > 0:
        step_mgr = CheckpointManager(os.path.abspath(os.path.join(args.output_dir, "steps")),
                                     max_to_keep=2, track_best=False, replicas=replicas)

        def step_cb(state, global_step):
            step_mgr.save(global_step, model, tx, state, acc1=0.0, best_acc1=best_acc1)

    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        state = trainer.train_epoch(state, train_loader, epoch, step_callback=step_cb,
                                    step_callback_freq=args.save_freq_steps,
                                    start_step=start_step)
        start_step = 0
        if trainer.stopped_early:
            spe = train_loader.steps_per_epoch()
            if trainer.next_global_step == (epoch + 1) * spe:
                # The stop registered at the epoch boundary: every batch ran.
                # Write the normal epoch checkpoint and skip validation (the
                # grace window is for saving, not scoring).
                mgr.save(epoch, model, tx, state, acc1=0.0, best_acc1=best_acc1, wait=True)
                say(f"=> preempted at the epoch-{epoch} boundary; epoch checkpoint "
                    f"saved (validate skipped). Continue with: --resume {args.output_dir}",
                    flush=True)
            else:
                # Every replica must stop before the same step: the stop flag
                # agrees by construction, and this records it.
                steps_by_rank = gather_int(trainer.next_global_step, replicas,
                                           "all_reduce (the preemption's step)")
                if len(set(steps_by_rank)) != 1:
                    raise ReplicaMismatch(f"the replicas stopped before different global "
                                          f"steps {steps_by_rank}")
                # Keyed by the next global step to run.
                pdir = os.path.join(os.path.abspath(args.output_dir), "preempt")
                pmgr = CheckpointManager(pdir, max_to_keep=1, track_best=False,
                                         replicas=replicas)
                pmgr.save(trainer.next_global_step, model, tx, state, acc1=0.0,
                          best_acc1=best_acc1, wait=True)
                if is_main:
                    # Pins steps_per_epoch, so that a mid-epoch resume with another
                    # batch size or dataset is refused. Written to a temporary file
                    # and renamed: a kill mid-write leaves no torn meta.json.
                    meta_path = os.path.join(pdir, "meta.json")
                    with open(meta_path + ".tmp", "w") as f:
                        json.dump({"steps_per_epoch": spe, "global_batch": args.batch_size,
                                   "steps_by_rank": steps_by_rank}, f)
                    os.replace(meta_path + ".tmp", meta_path)
                say(f"=> preempted at global step {trainer.next_global_step}; checkpoint "
                    f"saved to {pdir}. Continue with: --resume {args.output_dir}",
                    flush=True)
            break
        acc1, acc5, _ = trainer.validate(state, val_loader)
        ema_note = ""
        if args.model_ema:
            # The TF recipe evaluates (and tracks best by) the weight moving
            # average; the raw-weight score is printed beside it.
            raw_acc1 = acc1
            acc1, acc5, _ = trainer.validate(state, val_loader, verbose=False,
                                             params_override=get_ema_params(tx))
            ema_note = f" (ema; raw={raw_acc1:.3f})"
        is_best = acc1 > best_acc1
        best_acc1 = max(acc1, best_acc1)
        mgr.save(epoch, model, tx, state, acc1, best_acc1, is_best=is_best)
        say(f"epoch {epoch}: acc1={acc1:.3f}{ema_note} acc5={acc5:.3f} "
            f"best={best_acc1:.3f}{' *' if is_best else ''} "
            f"({time.perf_counter() - t0:.1f}s)", flush=True)
        # The exact decoder-fallback counts (the per-image warning only
        # samples occurrences), by every rank: each decodes its own shard.
        fb = train_loader.fallback_count + val_loader.fallback_count
        if fb:
            print(f"[rank {rank}] decoder-fallbacks: {fb} (train "
                  f"{train_loader.fallback_count}, val {val_loader.fallback_count})", flush=True)
    if args.bn_recalibrate and not trainer.stopped_early:
        # Exact running-stat refresh with frozen weights, then re-validate and
        # save as the post-training checkpoint (key = --epochs, one past the
        # last training epoch, so both the raw and the recalibrated final are
        # kept). With --model-ema the statistics are those of the EMA
        # weights, the model that is scored and deployed; the checkpoint
        # pairs them with the EMA shadow in its optimizer state.
        from mnasnet_tpu_torch.train.bn_recal import recalibrate_bn

        ema = get_ema_params(tx) if args.model_ema else None
        with swapped_params(model, ema):
            recalibrate_bn(model, train_loader, num_batches=args.bn_recalibrate,
                           compute_dtype=dtype, verbose=is_main, replicas=replicas)
            acc1, acc5, _ = trainer.validate(state, val_loader)
        ema_note = " (ema weights, ema-paired stats)" if ema is not None else ""
        is_best = acc1 > best_acc1
        best_acc1 = max(acc1, best_acc1)
        mgr.save(args.epochs, model, tx, state, acc1, best_acc1, is_best=is_best)
        say(f"bn-recalibrated: acc1={acc1:.3f}{ema_note} acc5={acc5:.3f} "
            f"best={best_acc1:.3f}{' *' if is_best else ''}", flush=True)
    # Shared shutdown for the normal end and the preemption break.
    mgr.wait()
    if step_mgr is not None:
        step_mgr.wait()
        step_mgr.close()
    if step_tracer is not None:
        step_tracer.close()
    if writer is not None:
        writer.close()


if __name__ == "__main__":
    main()
