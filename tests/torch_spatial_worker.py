"""The ranks of tests/test_torch_spatial.py: gloo groups on the CPU laid out
as ``data × spatial`` meshes, and the runs the test repeats in one process.
Imports no JAX: the spawned workers start from this module.

Configuration: mnasnet0_35, 8 classes, 64 px, external BN EMA, s2d stem.
The float64 runs take the torch routes (the kernels' plain versions round
to fp32 by design) with the model cast to float64; the fp32 runs take the
kernel route (the kernels' plain versions on the CPU). A global batch of 8
images: 8 a shard on a 1x2 mesh, 4 on a 2x2 mesh.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.data.dataset import SyntheticDataset
from mnasnet_tpu_torch.data.pipeline import DataLoader
from mnasnet_tpu_torch.data.transforms import eval_transform, train_transform
from mnasnet_tpu_torch.models.layers import BatchNorm, set_replicas
from mnasnet_tpu_torch.parallel import (
    close,
    data_layout,
    init_distributed,
    make_mesh,
    shard_batch,
    use_mesh,
)
from mnasnet_tpu_torch.train.bn_recal import recalibrate_bn
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_train_step, step_collectives
from mnasnet_tpu_torch.train.trainer import Trainer

ALPHA, CLASSES, IMAGE, BATCH = 0.35, 8, 64, 8
LOADER_SAMPLES, VAL_SAMPLES = 24, 13  # 3 train steps; val: a padded tail


def batch(dtype=torch.float64, seed=11):
    """The global batch: images (8, 64, 64, 3) and labels, one of them -1."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.standard_normal((BATCH, IMAGE, IMAGE, 3))).to(dtype)
    labels = torch.from_numpy(rng.integers(0, CLASSES, BATCH))
    labels[5] = -1
    return images, labels


def model(dtype=torch.float64, dropout=0.2, seed=3, route=None, remat=False, momentum=0.9997):
    """The float64 model on the torch routes (or an fp32 one on ``route``),
    its BN affine and statistics perturbed from ``seed``, its classifier
    scaled down (better conditioned than the init's). ``momentum`` 0 keeps
    a step's batch moments as the running statistics."""
    route = route or ("torch" if dtype == torch.float64 else "kernel")
    m = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, dropout=dropout,
                     bn_ema="external", stem_s2d=True, dw_impl=route, bn_bwd=route, seed=seed,
                     remat=remat, bn_momentum=momentum)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, BatchNorm):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g) * 0.1)
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) + 0.5)
        m.classifier[1].weight.mul_(0.05)
    if dtype == torch.float64:
        m.double()
        m.dtype = dtype
    return m


def _state(m):
    return {"params": {n: p.detach().clone() for n, p in m.named_parameters()},
            "stats": {n: b.clone() for n, b in m.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def step_run(replicas=None, dtype=torch.float64, remat=False, steps=2, sd=None, dropout=0.2,
             lr=1e-3):
    """The logits of an eval forward on the global batch (this rank's part
    of it under ``replicas``), then ``steps`` sync-BN SGD steps on it:
    losses, counts, collectives (and the predicted ones), the state. With
    ``sd`` (the reference's weights) the model loads it and keeps each
    step's batch moments as its running statistics."""
    m = model(dtype, dropout=dropout, remat=remat, momentum=0.9997 if sd is None else 0.0)
    if sd is not None:
        m.load_state_dict(sd)
    tx = create_optimizer("sgd", lr)
    state = TrainState.create(m, tx, seed=0)
    images, labels = batch(dtype)
    if replicas is not None:
        set_replicas(m, replicas)
        images, labels = shard_batch(replicas, images, labels)
    out = {"losses": [], "counts": [], "collectives": []}
    with torch.no_grad():
        before = replicas.collectives if replicas is not None else 0
        out["logits"] = m.eval()(images.permute(0, 3, 1, 2))
        out["eval_collectives"] = (replicas.collectives if replicas is not None else 0) - before
    if replicas is not None:
        out["eval_predicted"] = m.spatial_collectives(IMAGE, replicas.mesh.spatial, train=False)
    step = make_train_step(m, tx, 0.1, replicas=replicas)
    for _ in range(steps):
        before = replicas.collectives if replicas is not None else 0
        state, met = step(state, images, labels)
        out["losses"].append(float(met["loss"]))
        out["counts"].append((int(met["top1"]), int(met["top5"]), int(met["count"])))
        out["collectives"].append((replicas.collectives if replicas is not None else 0) - before)
    if replicas is not None:
        out["predicted"] = step_collectives(m, image_rows=IMAGE)
    out.update(_state(m))
    return out


def _loader(samples, seed, train, replicas=None):
    shard, shards = data_layout(replicas)
    tf = (lambda img, rng: train_transform(img, IMAGE, rng)) if train \
        else (lambda img: eval_transform(img, IMAGE))
    return DataLoader(SyntheticDataset(samples, IMAGE, CLASSES, seed=seed), BATCH // shards, tf,
                      shuffle=train, drop_last=train, seed=0, workers=0, augment=train,
                      shard_id=shard, num_shards=shards)


def trainer_run(replicas=None) -> dict:
    """A float64 ``Trainer`` epoch (3 steps, augmented) and a validation of
    13 images (a padded tail) through it; then recalibration over the
    train loader: the state after each and the validation's result."""
    m = model(dropout=0.0)  # a shard's rows of the mask follow the loader's order
    trainer = Trainer(m, create_optimizer("sgd", 1e-3), device="cpu", label_smoothing=0.1,
                      compute_dtype=torch.float64, print_freq=1000, replicas=replicas)
    state = trainer.create_state(0)
    trainer.train_epoch(state, _loader(LOADER_SAMPLES, 0, True, replicas), 0)
    out = {"train": _state(m)}
    out["validation"] = trainer.validate(state, _loader(VAL_SAMPLES, 1, False, replicas),
                                         verbose=False)
    recalibrate_bn(m, _loader(LOADER_SAMPLES, 0, True, replicas), compute_dtype=torch.float64,
                   verbose=False, replicas=replicas)
    out["recal"] = _state(m)["stats"]
    return out


def run(rank: int, world: int, rendezvous: str, out_dir: str, sd_file: str) -> None:
    """One rank: at world 2 the 1x2 mesh's runs, the fp32 kernel-route step
    of the reference's weights, and a step on the ``dcn=2`` mesh and on the
    flat mesh; at world 4 the 2x2 mesh's runs."""
    torch.set_num_threads(1)
    replicas = init_distributed(f"file://{rendezvous}", world, rank, "gloo", "cpu")
    try:
        out = {}
        if world == 2:
            sd = torch.load(sd_file)
            for name, mesh in (("flat", make_mesh(2)), ("dcn", make_mesh(2, dcn=2))):
                use_mesh(replicas, mesh)
                out[name] = step_run(replicas, torch.float32, steps=1, sd=sd, dropout=0.0)
        use_mesh(replicas, make_mesh(world, data=world // 2, spatial=2))
        out["step"] = step_run(replicas)
        out["remat"] = step_run(replicas, remat=True)
        out["trainer"] = trainer_run(replicas)
        if world == 2:
            out["fp32"] = step_run(replicas, torch.float32, steps=1, sd=sd, dropout=0.0)
        torch.save(out, os.path.join(out_dir, f"world{world}_rank{rank}.pt"))
    finally:
        close(replicas)
