"""Memory and speed of the production train step against ``--grad-accum``.

Counterpart of ``tools/memory_probe.py``, which reads the XLA compiler's
buffer totals of the jitted step without running it. The port has no such
analysis, so it counts and measures:

  (a) an account that holds on any device: the bytes that one microbatch's
      train-mode forward saves for the backward (``saved_tensors_hooks``,
      each storage once, the parameters' own left out; the activations apart
      from the weights' casts: the counterpart of ``temp_size_mib``), and the
      bytes of the parameters, the buffers (BN statistics) and the optimizer
      state (``argument_size_mib``);
  (b) on the card, the production step (``create_model(arch, dtype=bf16,
      bn_ema="external", stem_s2d=True)``, RMSProp ``fused="small"``, label
      smoothing 0.1) on ``TRAIN_ROUTE``, for each global batch B and each K
      with B/K at least ``--min-microbatch``: the peak allocated and reserved
      memory above the base, ms per step (CUDA events, the median of
      ``--repeats`` windows), images/s and the kernels' launches per counted
      step (``tools/train_variants.py:time_train``). The steps of one B run
      in turns, K ascending then descending (``RUNS``), B 256 first:
      the reference's comparison was bs256 direct against 2x128
      (``ACCUM_OVERHEAD_r04.json``). A ``torch.cuda.OutOfMemoryError`` is
      recorded in its row as ``"oom": true`` and the sweep goes on.

``auto_rule`` then says whether accumulating microbatches of
``MICROBATCH_LIMIT`` beats the direct step at B 256 and 512 by more than the
two runs' spread, the test that ``train/steps.py:CUDA_MICROBATCH_LIMIT``
is set from.

    python -m mnasnet_tpu_torch.tools.memory_probe [--arch mnasnet1_0] \\
        [--batch-sizes 128,256,512,1024] [--accums 1,2,4,8] [--out F.json]
    python -m mnasnet_tpu_torch.tools.memory_probe --device cpu --arch mnasnet0_35 \\
        --image-size 32 --batch-sizes 8 --accums 1,2 --min-microbatch 1 --out m.json

Runs on the card (``--device``, default cuda) and exits non-zero when the
device it is asked for is not there; with ``--device cpu`` only (a) runs and
the card's keys are null.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
from pathlib import Path

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.tools.train_variants import LR, VARIANTS, time_train, train_batch
from mnasnet_tpu_torch.train.loss import cross_entropy
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import MICROBATCH_LIMIT
from mnasnet_tpu_torch.utils.card import card_info, open_device
from mnasnet_tpu_torch.utils.routing import default_train_route

LABEL_SMOOTHING = 0.1
# The production configuration (bench.py's): model knobs and the optimizer's.
PRODUCTION = VARIANTS["best"]
# Runs of each (B, K), in turns: the spread the auto rule compares against.
RUNS = 2


def production_model(arch: str, device, seed: int = 0):
    knobs = {k: v for k, v in PRODUCTION.items() if k != "fused"}
    model = create_model(arch, device=device, dtype=torch.bfloat16, seed=seed, **knobs)
    tx = create_optimizer("rmsprop", LR, fused=PRODUCTION["fused"])
    TrainState.create(model, tx, seed=seed)
    return model, tx


def argument_bytes(model, tx) -> dict:
    """Bytes of the state a step reads and writes in place."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = {"params": nbytes(model.parameters()), "buffers": nbytes(model.buffers()),
           "optimizer": nbytes(tx.tensors())}
    out["total"] = sum(out.values())
    return out


class _ParamDerived(TorchDispatchMode):
    """Tracks the storages computed from the parameters and buffers alone
    (the per-forward casts and reshapes of the weights): an op whose tensor
    inputs all lie in such storages marks its outputs' storages, any other
    op unmarks them (a freed storage's address may be reused)."""

    def __init__(self, owned: set):
        super().__init__()
        self.derived = set(owned)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        mark = bool(ins) and all(t.untyped_storage().data_ptr() in self.derived for t in ins)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                (self.derived.add if mark else self.derived.discard)(
                    t.untyped_storage().data_ptr())
        return out


def saved_bytes(model, images, labels, seed: int = 0) -> dict:
    """Bytes the train-mode forward and loss of ``images`` (NHWC) save for
    the backward, each saved storage counted once, the parameters' and
    buffers' own left out (they are the step's arguments): ``activations``,
    and ``weight_casts`` (storages computed from the parameters alone, which
    every microbatch makes anew but whose size does not follow its rows)."""
    owned = {t.untyped_storage().data_ptr() for t in (*model.parameters(), *model.buffers())}
    seen: dict = {}
    mode = _ParamDerived(owned)

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() and s.data_ptr() not in owned:
            seen[s.data_ptr()] = (s.nbytes(), s.data_ptr() in mode.derived)
        # Detached: a saved output that kept its grad_fn would make a reference
        # cycle (tensor -> grad_fn -> saved tensor) that holds the whole graph
        # until the collector runs.
        return t.detach()

    x = images.permute(0, 3, 1, 2)
    generator = torch.Generator(device=x.device).manual_seed(seed)
    was_training = model.training
    model.train()
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), mode:
            keep = model.dropout_keep(x.shape[0], generator, x.device)
            loss = cross_entropy(model(x, keep=keep), labels, LABEL_SMOOTHING)
        del loss
    finally:
        model.train(was_training)
    return {"activations": sum(n for n, cast in seen.values() if not cast),
            "weight_casts": sum(n for n, cast in seen.values() if cast)}


def plan(batch_sizes, accums, min_microbatch) -> list[tuple[int, list[int]]]:
    """(B, the Ks of B) in the order they run: B 256 first, then ascending;
    a K must divide B and leave a microbatch of at least ``min_microbatch``."""
    order = sorted(batch_sizes, key=lambda b: (b != 256, b))
    return [(b, [k for k in sorted(accums) if b % k == 0 and b // k >= min_microbatch])
            for b in order]


def account(arch: str, image: int, schedule, device) -> dict:
    """(a): the argument bytes, and the saved bytes of each microbatch size."""
    model, tx = production_model(arch, device)
    out = {"argument_bytes": argument_bytes(model, tx), "saved_by_microbatch": {}}
    g = torch.Generator(device=device).manual_seed(5)
    for m in sorted({b // k for b, ks in schedule for k in ks}):
        images = torch.randn(m, image, image, 3, device=device, generator=g)
        labels = torch.randint(0, 1000, (m,), device=device, generator=g)
        out["saved_by_microbatch"][m] = saved_bytes(model, images, labels)
        del images, labels
    del model, tx
    return out


def measure(arch: str, image: int, schedule, repeats: int, target_ms: float, device) -> dict:
    """(b): {(B, K): [time_train row of each run, or {"oom": True}]}."""
    out: dict = {}
    for b, ks in schedule:
        images, labels = train_batch(b, device, image=image)
        for r in range(RUNS):
            for k in (ks if r % 2 == 0 else ks[::-1]):
                if any(run.get("oom") for run in out.get((b, k), [])):
                    continue
                try:
                    row = time_train(PRODUCTION, default_train_route(device), images, labels,
                                     target_ms=target_ms, grad_accum=k, arch=arch,
                                     repeats=repeats)
                except torch.cuda.OutOfMemoryError as e:
                    row = {"oom": True, "error": str(e).splitlines()[0][:300]}
                gc.collect()
                torch.cuda.empty_cache()
                out.setdefault((b, k), []).append(row)
                print(json.dumps({"batch_size": b, "grad_accum": k, "run": r,
                                  **{key: row.get(key) for key in
                                     ("oom", "ms_per_step", "images_per_s",
                                      "peak_allocated_gb", "peak_reserved_gb")}}), flush=True)
        del images, labels
    return out


def row_of(b: int, k: int, acct: dict, runs: list | None) -> dict:
    m = b // k
    saved = acct["saved_by_microbatch"][m]
    row = {"batch_size": b, "grad_accum": k, "microbatch": m,
           "saved_activation_bytes": saved["activations"],
           "saved_activation_mib": saved["activations"] / 2**20,
           "saved_weight_cast_bytes": saved["weight_casts"],
           "argument_bytes": acct["argument_bytes"]["total"],
           "argument_mib": acct["argument_bytes"]["total"] / 2**20,
           "oom": None, "ms_per_step": None, "ms_runs": None, "images_per_s": None,
           "peak_allocated_gb": None, "peak_reserved_gb": None, "launches_per_step": None}
    if runs is None:
        return row
    row["oom"] = any(r.get("oom") for r in runs)
    if row["oom"]:
        row["error"] = next(r["error"] for r in runs if r.get("oom"))
        return row
    row["ms_runs"] = [r["ms_per_step"] for r in runs]
    row["ms_per_step"] = statistics.median(v for r in runs for v in r["ms_repeats"])
    row["images_per_s"] = b / row["ms_per_step"] * 1e3
    row["peak_allocated_gb"] = max(r["peak_allocated_gb"] for r in runs)
    row["peak_reserved_gb"] = max(r["peak_reserved_gb"] for r in runs)
    row["launches_per_step"] = runs[0]["launches_per_step"]
    row["route"] = runs[0]["route"]
    return row


def auto_rule(rows: list, limit: int = MICROBATCH_LIMIT, batches=(256, 512)) -> dict | None:
    """Whether microbatches of ``limit`` beat the direct step at each of
    ``batches`` by more than the two runs' spread: every run of the
    accumulated step faster than every run of the direct one. None without
    the card's numbers."""
    by = {(r["batch_size"], r["grad_accum"]): r for r in rows}
    out = {}
    for b in batches:
        direct, acc = by.get((b, 1)), by.get((b, b // limit))
        if not direct or not acc or direct["ms_runs"] is None or acc["ms_runs"] is None:
            return None
        out[str(b)] = {
            "direct_ms_runs": direct["ms_runs"], "accumulated_ms_runs": acc["ms_runs"],
            "grad_accum": b // limit,
            "direct_images_per_s": direct["images_per_s"],
            "accumulated_images_per_s": acc["images_per_s"],
            "direct_peak_allocated_gb": direct["peak_allocated_gb"],
            "accumulated_peak_allocated_gb": acc["peak_allocated_gb"],
            "accumulated_beats_direct": max(acc["ms_runs"]) < min(direct["ms_runs"])}
    accumulate = all(v["accumulated_beats_direct"] for v in out.values())
    return {"by_batch": out, "accumulate": accumulate,
            "microbatch_limit": limit if accumulate else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mnasnet1_0")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch-sizes", default="128,256,512,1024")
    ap.add_argument("--accums", default="1,2,4,8")
    ap.add_argument("--min-microbatch", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=5, help="timed windows of each run")
    ap.add_argument("--target-ms", type=float, default=300.0, help="length of one window")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("build/memory_probe.json"))
    args = ap.parse_args(argv)
    device = open_device(args.device, "memory_probe")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    schedule = plan([int(b) for b in args.batch_sizes.split(",")],
                    [int(k) for k in args.accums.split(",")], args.min_microbatch)
    acct = account(args.arch, args.image_size, schedule, device)
    measured = (measure(args.arch, args.image_size, schedule, args.repeats, args.target_ms,
                        device) if device.type == "cuda" else {})
    rows = [row_of(b, k, acct, measured.get((b, k)) if measured else None)
            for b, ks in schedule for k in ks]
    out = {"tool": "memory_probe", **card_info(device), "arch": args.arch,
           "image_size": args.image_size, "dtype": "bfloat16",
           "config": "production: bn_ema=external, stem_s2d, RMSProp fused=small, "
                     "label smoothing 0.1",
           "route": default_train_route(device) if device.type == "cuda" else None,
           "argument_bytes": acct["argument_bytes"],
           "method": "saved bytes: saved_tensors_hooks over one microbatch's train forward "
                     "and loss, each storage once; card: time_train rows, peak memory "
                     "above the base, ms per step the median of every timed window of "
                     f"{RUNS} runs in turns",
           "rows": rows, "auto_rule": auto_rule(rows)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({"auto_rule": out["auto_rule"]}))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
