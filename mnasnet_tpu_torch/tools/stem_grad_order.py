"""The stem's weight gradient of one sync-BN step over two ranks of 8 images
against one process on the same 16, in fp32 and in float64.

    python -m mnasnet_tpu_torch.tools.stem_grad_order [--device cuda]
        [--out build/stem_grad_order.json]

``multihost_smoke``'s one-step check compares two ranks with one process,
and its worst leaf is the stem conv's weight (``layers.0.weight``). This
tool asks whether that gap is the summation order or a fault: on
``tools/multihost.py:small_flags``' model (mnasnet0_35 at 32 px, 8 classes,
seed 0, dropout on) and 16 seeded images, it takes the global gradient of
the stem's weight as the optimizer receives it (after the ranks' sums) from

  * one process on the 16 images, and the same on images moved by one fp32
    ulp (the step's own sensitivity to rounding);
  * two ranks of 8 images each, sync-BN (gloo, both on the same device);

in fp32 on the kernel route (the CLI's) with cuDNN's TF32 on (PyTorch's
default, the CLI's without ``--deterministic``) and off, on the torch route
with TF32 off, and in float64 on the torch route (the kernels take bf16 and
fp32). In float64 the two orders of summation agree to float64 rounding if
the sums are right; the fp32 gaps are then rounding, to be read against the
fp32 one-process gradient's own error (against float64) and its one-ulp
move. Writes a JSON with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

ARCH, CLASSES, IMAGE, BATCH, WORLD = "mnasnet0_35", 8, 32, 16, 2
LEAF = "layers.0.weight"
# (dtype, route, cuDNN's TF32)
VARIANTS = (("float32", "kernel", True), ("float32", "kernel", False),
            ("float32", "torch", False), ("float64", "torch", False))
REPO = Path(__file__).resolve().parents[2]


def batch(dtype: torch.dtype, nudge: bool = False):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((BATCH, IMAGE, IMAGE, 3))).to(dtype)
    y = torch.from_numpy(rng.integers(0, CLASSES, BATCH))
    if nudge:
        ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -52
        x = x * (1 + ulp * torch.from_numpy(rng.integers(0, 2, x.shape) * 2 - 1).to(dtype))
    return x, y


def stem_grad(dtype_name: str, route: str, tf32: bool, device, replicas=None,
              nudge=False) -> torch.Tensor:
    """The stem weight's gradient of one step (global over the ranks), in
    the model's dtype, on the CPU."""
    torch.backends.cudnn.allow_tf32 = tf32
    from mnasnet_tpu_torch import create_model
    from mnasnet_tpu_torch.models.layers import set_replicas
    from mnasnet_tpu_torch.parallel import shard_batch
    from mnasnet_tpu_torch.train.optim import create_optimizer
    from mnasnet_tpu_torch.train.state import TrainState
    from mnasnet_tpu_torch.train.steps import make_train_step

    dtype = getattr(torch, dtype_name)
    model = create_model(ARCH, device=device, num_classes=CLASSES, dw_impl=route, bn_bwd=route,
                         seed=0)
    if dtype == torch.float64:  # the port's compute dtypes are bf16 and fp32
        model.double()
        model.dtype = dtype
    tx = create_optimizer("sgd", 1e-4)
    state = TrainState.create(model, tx, seed=0)
    x, y = batch(dtype, nudge)
    if replicas is not None:
        set_replicas(model, replicas)
        x, y = shard_batch(replicas, x, y)
    seen = {}
    apply = tx.apply

    def record(grads):
        seen["g"] = grads[LEAF].detach().cpu().clone()
        return apply(grads)

    tx.apply = record
    make_train_step(model, tx, 0.1, replicas=replicas, route="eager")(state, x, y)
    return seen["g"]


def _rank(rank: int, rendezvous: str, out: str, device: str) -> None:
    from mnasnet_tpu_torch.parallel import close, init_distributed

    torch.backends.cudnn.deterministic = True
    replicas = init_distributed(f"file://{rendezvous}", WORLD, rank, "gloo", device)
    try:
        grads = {_key(*v): stem_grad(*v, replicas.device, replicas) for v in VARIANTS}
        torch.save(grads, os.path.join(out, f"rank{rank}.pt"))
    finally:
        close(replicas)


def _key(dtype_name: str, route: str, tf32: bool) -> str:
    return f"{dtype_name}/{route}" + ("/tf32" if tf32 else "")


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def measure(device: str) -> dict:
    import torch.multiprocessing as mp

    from mnasnet_tpu_torch.utils.card import card_info

    torch.backends.cudnn.deterministic = True
    rank_device = "cuda:0" if device == "cuda" else device
    with tempfile.TemporaryDirectory() as work:
        mp.start_processes(_rank, args=(os.path.join(work, "rdv"), work, rank_device),
                           nprocs=WORLD, start_method="spawn")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(WORLD)]
    one = {_key(*v): stem_grad(*v, rank_device) for v in VARIANTS}
    exact = one["float64/torch"]
    out = {"leaf": LEAF, "arch": ARCH, "image_size": IMAGE, "batch": BATCH, "world": WORLD,
           "backend": "gloo", **card_info(torch.device(rank_device)), "variants": {}}
    for d, r, tf32 in VARIANTS:
        key = _key(d, r, tf32)
        two = ranks[0][key]
        row = {"ranks_equal": torch.equal(two, ranks[1][key]),
               "two_ranks_vs_one_rel_rms": _rel_rms(two, one[key]),
               "two_ranks_vs_one_max_abs": float((two - one[key]).abs().max()),
               "one_process_max_abs": float(one[key].abs().max())}
        if d == "float32":
            moved = stem_grad(d, r, tf32, rank_device, nudge=True)
            row.update(one_ulp_move_rel_rms=_rel_rms(moved, one[key]),
                       one_process_vs_float64_rel_rms=_rel_rms(one[key], exact),
                       two_ranks_vs_float64_rel_rms=_rel_rms(two, exact))
        out["variants"][key] = row
    f64 = out["variants"]["float64/torch"]
    out["float64_orders_agree"] = f64["two_ranks_vs_one_rel_rms"] < 1e-12
    out["ok"] = out["float64_orders_agree"] and all(
        v["ranks_equal"] for v in out["variants"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (both ranks on cuda:0) or cpu")
    ap.add_argument("--out", default=str(REPO / "build" / "stem_grad_order.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("stem_grad_order: no CUDA device; --device cpu runs it on the CPU")
        return 2
    out = measure(args.device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
