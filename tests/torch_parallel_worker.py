"""One rank of the 2-process gloo group of tests/test_torch_parallel.py, and
the port's runs that the test repeats in one process. Imports no JAX: the
spawned workers start from this module.

Configuration (the test's): mnasnet0_35, 8 classes, fp32 on the CPU, the
kernel route (the kernels' plain versions), external BN EMA, s2d stem,
RMSProp with ``fused="small"``, label smoothing 0.1. The step runs take
64 px images, 8 per rank (16 in one process), at a learning rate of 1e-4;
the trainer runs 32 px, 4 per rank (8 in one process), at 1e-3.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.data.dataset import SyntheticDataset
from mnasnet_tpu_torch.data.pipeline import DataLoader
from mnasnet_tpu_torch.data.transforms import eval_transform, train_transform
from mnasnet_tpu_torch.models.layers import BatchNorm, nchw, set_replicas
from mnasnet_tpu_torch.ops.cuda.bn_bwd import batch_moments, bn_relu_train
from mnasnet_tpu_torch.parallel import close, init_distributed
from mnasnet_tpu_torch.train.bn_recal import recalibrate_bn
from mnasnet_tpu_torch.train.checkpoint import CheckpointManager
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_local_bn_train_step, make_train_step
from mnasnet_tpu_torch.train.trainer import Trainer

ALPHA, CLASSES = 0.35, 8
WORLD = 2
STEP_IMAGE, STEP_BATCH = 64, 16          # global batch of the step runs
TRAINER_IMAGE, TRAINER_BATCH = 32, 8     # global batch of the trainer runs
TRAINER_SAMPLES, VAL_SAMPLES = 40, 13    # 5 steps; val: a tail and shard padding
STOP_AFTER = 1                           # rank 1 asks to stop after this step


def bn_case(seed=0):
    """NHWC x (8, 6, 6, 16), dy, γ, β: both halves hold 4 images."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 6, 6, 16)).astype(np.float32) * 2 + 0.5
    dy = rng.standard_normal(x.shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    beta = (rng.standard_normal(16) * 0.3).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, dy, gamma, beta)]


def bn_run(route, stats, x, dy, gamma, beta, replicas=None):
    """The BN+ReLU region's forward and backward on x: the kernel route
    (``bn_relu_train``) or the torch route (``BatchNorm`` and autograd).
    Returns the moments, dx, dγ, dβ and the running statistics."""
    x = x.clone().requires_grad_(True)
    g = gamma.clone().requires_grad_(True)
    b = beta.clone().requires_grad_(True)
    out = {"moments": batch_moments(x.detach(), stats, replicas)}
    if route == "kernel":
        y, mean, var = bn_relu_train(x, g, b, 1e-5, stats, replicas)
    else:
        bn = BatchNorm(x.shape[-1], stats=stats)
        bn.replicas = replicas
        bn.train()
        with torch.no_grad():
            bn.weight.copy_(gamma)
            bn.bias.copy_(beta)
        g, b = bn.weight, bn.bias
        y = torch.relu(bn(nchw(x))).permute(0, 2, 3, 1)
        out["running"] = (bn.running_mean.clone(), bn.running_var.clone())
    y.backward(dy)
    out.update(dx=x.grad, dgamma=g.grad, dbeta=b.grad)
    return out


def step_case(seed=11):
    """The step runs' global batch: images (16, 64, 64, 3), labels; two of
    them are padding (-1), both in rank 1's half."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((STEP_BATCH, STEP_IMAGE, STEP_IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, STEP_BATCH).astype(np.int64)
    labels[[11, 14]] = -1
    return images, labels


def _model(sd, dropout, stats, remat=False):
    model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, dropout=dropout,
                         bn_stats=stats, bn_ema="external", stem_s2d=True, dw_impl="kernel",
                         bn_bwd="kernel", remat=remat)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model


def port_step(sd, images, labels, *, replicas=None, local_bn=False, dropout=0.0,
              stats="two_pass", grad_accum=1, steps=1, remat=False):
    """``steps`` train steps from the weights ``sd`` on this process's batch:
    the sync-BN step, the local-BN step, or (no replicas) the one-process
    step, of the model with rematerialised blocks under ``remat``. Returns
    the losses, the counts, the parameters, the BN statistics and the
    collectives of each step."""
    model = _model(sd, dropout, stats, remat)
    tx = create_optimizer("rmsprop", 1e-4, fused="small")
    state = TrainState.create(model, tx, seed=0)
    if local_bn:
        step = make_local_bn_train_step(model, tx, 0.1, replicas)
    else:
        set_replicas(model, replicas)
        step = make_train_step(model, tx, 0.1, grad_accum=grad_accum, replicas=replicas)
    out = {"losses": [], "counts": [], "collectives": []}
    for _ in range(steps):
        before = replicas.collectives if replicas is not None else 0
        state, m = step(state, images, labels)
        out["losses"].append(float(m["loss"]))
        out["counts"].append((int(m["top1"]), int(m["top5"]), int(m["count"])))
        out["collectives"].append((replicas.collectives if replicas is not None else 0) - before)
    out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    out["stats"] = {n: b.clone() for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
    return out


def trainer_model(seed=3, dropout=0.0):
    """The trainer runs' model, its BN affine perturbed and its classifier
    scaled down as the step runs' weights are (better conditioned than the
    init at random weights)."""
    model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, dropout=dropout,
                         bn_stats="one_pass", bn_ema="external", stem_s2d=True,
                         dw_impl="kernel", bn_bwd="kernel", seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
        model.classifier[1].weight.mul_(0.05)
    return model


def train_loader(world=1, rank=0):
    return DataLoader(SyntheticDataset(TRAINER_SAMPLES, TRAINER_IMAGE, CLASSES, seed=0),
                      TRAINER_BATCH // world,
                      lambda img, rng: train_transform(img, TRAINER_IMAGE, rng), shuffle=True,
                      drop_last=True, seed=0, workers=0, shard_id=rank, num_shards=world)


def val_loader(world=1, rank=0):
    return DataLoader(SyntheticDataset(VAL_SAMPLES, TRAINER_IMAGE, CLASSES, seed=1),
                      TRAINER_BATCH // world, lambda img: eval_transform(img, TRAINER_IMAGE),
                      shuffle=False, drop_last=False, workers=0, augment=False,
                      shard_id=rank, num_shards=world)


def make_trainer(replicas=None, seed=3):
    model = trainer_model(seed)
    tx = create_optimizer("rmsprop", 1e-3, fused="small")
    trainer = Trainer(model, tx, device="cpu", label_smoothing=0.1, print_freq=1000,
                      replicas=replicas)
    return model, tx, trainer, trainer.create_state(0)


def snapshot(model, tx, state) -> dict:
    return {"model": {k: v.clone() for k, v in model.state_dict().items()},
            "optimizer": tx.state_dict(), "train_state": state.state_dict()}


def recal_run(replicas=None):
    """The statistics of recalibration over 3 global batches."""
    model = trainer_model(seed=4)
    recalibrate_bn(model, train_loader(*_layout(replicas)), num_batches=3, verbose=False,
                   replicas=replicas)
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def validation_run(replicas=None):
    """(top-1 %, top-5 %, loss) of a perturbed model over the val set."""
    model = trainer_model(seed=5)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    trainer = Trainer(model, create_optimizer("sgd", 0.1), device="cpu", print_freq=1000,
                      replicas=replicas)
    return trainer.validate(None, val_loader(*_layout(replicas)), verbose=False)


def _layout(replicas):
    return (1, 0) if replicas is None else (replicas.world, replicas.rank)


def resume_and_finish(ckpt_dir, key, replicas=None):
    """Restore the preemption checkpoint ``key`` into a fresh trainer and run
    the rest of epoch 0; the restored state and the final one."""
    model, tx, trainer, state = make_trainer(replicas, seed=9)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=1, track_best=False, replicas=replicas)
    mgr.restore(model, tx, state, epoch=key)
    restored = snapshot(model, tx, state)
    spe = train_loader().steps_per_epoch()
    state = trainer.train_epoch(state, train_loader(*_layout(replicas)), 0,
                                start_step=key % spe)
    return restored, snapshot(model, tx, state)


def stop_run(replicas, ckpt_dir):
    """Rank 1 alone asks to stop after step ``STOP_AFTER``; the stop, the
    preemption checkpoint (who wrote it) and the resumed run at this world."""
    model, tx, trainer, state = make_trainer(replicas)
    writes = []
    orig_write = CheckpointManager._write

    def counted_write(self, key, payload):
        writes.append(key)
        return orig_write(self, key, payload)

    def ask_to_stop(state, gstep):
        if replicas.rank == 1 and gstep == STOP_AFTER:
            trainer.request_stop()

    state = trainer.train_epoch(state, train_loader(replicas.world, replicas.rank), 0,
                                step_callback=ask_to_stop, step_callback_freq=1)
    key = trainer.next_global_step
    CheckpointManager._write = counted_write
    try:
        CheckpointManager(ckpt_dir, max_to_keep=1, track_best=False, replicas=replicas).save(
            key, model, tx, state, acc1=0.0, best_acc1=0.0)
    finally:
        CheckpointManager._write = orig_write
    restored, final = resume_and_finish(ckpt_dir, key, replicas)
    return {"stopped_early": trainer.stopped_early, "next_global_step": key,
            "steps_run": state.step, "writes": writes, "restored": restored, "final": final}


def run(rank: int, rendezvous: str, work: str) -> None:
    """Every 2-rank scenario on this rank; the results go to ``rank<R>.pt``."""
    torch.set_num_threads(1)
    replicas = init_distributed(f"file://{rendezvous}", WORLD, rank, "gloo", "cpu")
    try:
        sd = torch.load(os.path.join(work, "weights.pt"), weights_only=True)
        images, labels = step_case()
        rows = slice(rank * STEP_BATCH // WORLD, (rank + 1) * STEP_BATCH // WORLD)
        x, y = images[rows], labels[rows]
        out = {"bn": {}}
        bx, bdy, gamma, beta = bn_case()
        half = slice(rank * 4, (rank + 1) * 4)
        for route in ("kernel", "torch"):
            for stats in ("one_pass", "two_pass"):
                out["bn"][route, stats] = bn_run(route, stats, bx[half], bdy[half], gamma, beta,
                                                 replicas)
        out["sync_dropout"] = port_step(sd, x, y, replicas=replicas, dropout=0.2,
                                        stats="one_pass", steps=2)
        out["sync_dropout_remat"] = port_step(sd, x, y, replicas=replicas, dropout=0.2,
                                              stats="one_pass", steps=2, remat=True)
        out["sync"] = port_step(sd, x, y, replicas=replicas)
        out["sync_remat"] = port_step(sd, x, y, replicas=replicas, remat=True)
        out["local"] = port_step(sd, x, y, replicas=replicas, local_bn=True)
        out["local_dropout"] = port_step(sd, x, y, replicas=replicas, local_bn=True,
                                         dropout=0.2, stats="one_pass")
        out["recal"] = recal_run(replicas)
        out["validation"] = validation_run(replicas)
        out["stop"] = stop_run(replicas, os.path.join(work, "ckpt"))
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        close(replicas)
