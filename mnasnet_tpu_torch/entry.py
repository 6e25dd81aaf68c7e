"""Entry points of the port for a compile check and a dry run: a forward to
check, and a multi-rank dry run of the data-parallel training step.

Counterpart of the root ``__graft_entry__.py``:

``entry(device="cuda")``
    -> (forward, example args) on the flagship model: mnasnet1_0 @224, bf16,
    eval mode, a batch of 8; ``forward(*args)`` gives (8, 1000) fp32 logits.
``dryrun_multichip(n, device="cuda")``
    starts ``n`` ranks (one process each, a ``file://`` rendezvous in a
    temporary directory) and on each, at tiny shapes (mnasnet1_0 at 32 px,
    2 images a rank, 16 classes, the production training configuration:
    external BN EMA, s2d stem, RMSProp ``fused="small"``), takes one
    sync-BN step and one local-BN step through the ``Trainer``, each on the
    route the ``Trainer`` takes (over NCCL the graph route: the warm-up
    step, then the capture with the collectives inside); then, on the card,
    the production shape: mnasnet1_0 @224 bf16 at 128 images a rank, one
    step captured on the graph route and one replay. That capture stands
    for the reference's ahead-of-time compile of its production-shape
    step. Between them, as the reference does (``__graft_entry__.py:
    148-162,193-208``), one sync-BN step at the tiny shapes on the
    ``dcn × data`` mesh ``2 × n/2`` (``n`` even and at least 4) and, last,
    one on the ``data × spatial`` mesh ``n/2 × 2`` (``n`` even): each rank
    holds its band of 16 of the 32 image rows of its data shard's 2 images,
    and the halo exchanges run over its spatial group's subgroup (inside
    the captured graph over NCCL). Rank 0 prints one line per step, as the
    reference does, and the spatial step's band plan.

Where the reference re-executes itself on a virtual CPU mesh when it has
fewer devices than asked, ``device="cuda"`` here raises, naming the count;
the ``n`` gloo ranks on the CPU run only when the caller passes
``device="cpu"``, and there the production-shape capture, which needs a
card, is not made.
"""

from __future__ import annotations

import math
import os
import tempfile

import torch

TINY_IMAGE, TINY_PER_RANK, TINY_CLASSES = 32, 2, 16
PROD_IMAGE, PROD_PER_RANK = 224, 128


def entry(device="cuda"):
    """(forward, example args): ``forward(images NHWC)`` of mnasnet1_0 in
    eval mode with bf16 compute, and a batch of 8 images at 224 px."""
    from mnasnet_tpu_torch import create_model
    from mnasnet_tpu_torch.train.steps import make_predict_fn

    model = create_model("mnasnet1_0", device=device, dtype=torch.bfloat16, seed=0)
    images = torch.ones(8, PROD_IMAGE, PROD_IMAGE, 3, dtype=torch.bfloat16,
                        device=next(model.parameters()).device)
    return make_predict_fn(model), (images,)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The data-parallel dry run over ``n_devices`` ranks (module docstring).
    Raises if a rank fails, or, on ``device="cuda"``, if this machine has
    fewer than ``n_devices`` cards."""
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, "
                               f"this machine has {have}; device='cpu' runs {n_devices} gloo "
                               "ranks on the CPU instead")
    elif kind != "cpu":
        raise ValueError(f"dryrun_multichip runs on 'cuda' or 'cpu', not {device!r}")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as work:
        mp.start_processes(_rank, args=(n_devices, kind, os.path.join(work, "rendezvous")),
                           nprocs=n_devices, start_method="spawn")


def _rank(rank: int, world: int, kind: str, rendezvous: str) -> None:
    from mnasnet_tpu_torch.parallel import Replicas, close
    from mnasnet_tpu_torch.parallel.dist import join_group

    if kind == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    join_group("nccl" if kind == "cuda" else "gloo", f"file://{rendezvous}", world, rank)
    replicas = Replicas(rank, world, dev)
    try:
        _dryrun(replicas)
    finally:
        close(replicas)


def _one_step(replicas, *, sync_bn: bool, image=TINY_IMAGE, per_rank=TINY_PER_RANK,
              classes=TINY_CLASSES, dtype=torch.float32, dw_impl="torch", replays=0):
    """One train step of mnasnet1_0 through a fresh ``Trainer`` on ones and
    zero labels (then ``replays`` more calls), on the replicas' mesh: each
    rank takes its band of its shard's ``per_rank`` images; the loss and the
    trainer."""
    from mnasnet_tpu_torch import create_model
    from mnasnet_tpu_torch.parallel import take_band
    from mnasnet_tpu_torch.train.optim import create_optimizer
    from mnasnet_tpu_torch.train.trainer import Trainer

    dev = replicas.device
    model = create_model("mnasnet1_0", device=dev, num_classes=classes, dtype=dtype,
                         dw_impl=dw_impl, bn_ema="external", stem_s2d=True, seed=0)
    trainer = Trainer(model, create_optimizer("rmsprop", 0.01, fused="small"), device=dev,
                      label_smoothing=0.1, compute_dtype=dtype, print_freq=1_000_000,
                      replicas=replicas, sync_bn=sync_bn)
    state = trainer.create_state(0)
    images = take_band(torch.ones(per_rank, image, image, 3, dtype=dtype, device=dev), replicas)
    labels = torch.zeros(per_rank, dtype=torch.long, device=dev)
    for _ in range(1 + replays):
        state, metrics = trainer.route(state, images, labels)
    loss = float(metrics["loss"])
    if state.step != 1 + replays or not math.isfinite(loss):
        raise RuntimeError(f"rank {replicas.rank}: after {1 + replays} calls the step is "
                           f"{state.step} and the loss {loss}")
    return loss, trainer


def _dryrun(replicas) -> None:
    from mnasnet_tpu_torch.parallel import make_mesh, use_mesh
    from mnasnet_tpu_torch.parallel.spatial import bands

    n = replicas.world
    say = print if replicas.rank == 0 else (lambda *a, **k: None)
    loss, trainer = _one_step(replicas, sync_bn=True)
    say(f"dryrun dp({n}x1): ok, loss={loss:.4f} ({trainer.route.route} route)", flush=True)
    loss_lb, trainer = _one_step(replicas, sync_bn=False)
    say(f"dryrun dp local-BN({n}x1): ok, loss={loss_lb:.4f} ({trainer.route.route} route)",
        flush=True)
    if n % 2 == 0 and n >= 4:
        use_mesh(replicas, make_mesh(n, dcn=2, data=n // 2))
        loss_dcn, trainer = _one_step(replicas, sync_bn=True)
        say(f"dryrun dcn x dp(2x{n // 2}): ok, loss={loss_dcn:.4f} ({trainer.route.route} "
            "route)", flush=True)
        use_mesh(replicas, make_mesh(n))
    if replicas.device.type == "cuda":
        prod, trainer = _one_step(replicas, sync_bn=True, image=PROD_IMAGE,
                                  per_rank=PROD_PER_RANK, classes=1000, dtype=torch.bfloat16,
                                  dw_impl="auto", replays=1)
        routed = trainer.route
        if routed.route != "graph" or list(routed.replays.values()) != [1]:
            raise RuntimeError(f"the production-shape step took the {routed.route} route "
                               f"with replays {routed.replays}, not one capture")
        say(f"dryrun production-shape capture (mnasnet1_0@224 bf16, batch {PROD_PER_RANK * n} "
            f"= {n}x{PROD_PER_RANK}, graph route, one replay): ok, loss={prod:.4f}",
            flush=True)
    else:
        say("dryrun production-shape capture: not made on the CPU (the graph route runs on a "
            "CUDA device)", flush=True)
    if n % 2 == 0:
        use_mesh(replicas, make_mesh(n, data=n // 2, spatial=2))
        loss_sp, trainer = _one_step(replicas, sync_bn=True)
        plan = " ".join(f"{h}:{'/'.join(str(b - a) for a, b in bands(h, 2))}"
                        for h, _ in trainer.model.planes(TINY_IMAGE, TINY_IMAGE))
        say(f"dryrun dp x sp band plan (plane rows: rows a band): {plan}", flush=True)
        say(f"dryrun dp x sp({n // 2}x2): ok, loss={loss_sp:.4f} ({trainer.route.route} route)",
            flush=True)
    say(f"dryrun_multichip({n}): ok, loss={loss:.4f}", flush=True)
