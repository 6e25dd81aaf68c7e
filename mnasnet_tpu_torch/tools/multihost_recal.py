"""BN recalibration over two ranks against one process: the counterpart of
``tools/multihost_recal.py``.

    python -m mnasnet_tpu_torch.tools.multihost_recal [--n-classes 200]
        [--out build/multihost_recal.json]

  * the dress rehearsal's on-disk tree (``dress_rehearsal.make_tree``);
  * two ranks of the train CLI train one epoch in fp32, then
    ``--bn-recalibrate N``: N global batches, each the two ranks' shards,
    whose per-batch moments sync-BN sums over the ranks; the recalibrated
    state is saved under key 1 beside the epoch's key 0;
  * the one-process oracle (``multihost.oracle``) resumes key 0 and
    recalibrates over the same global batches: the shards of each step
    concatenated in rank order. The loader's shards are strided, so the
    two ranks' batch i holds the samples of the one process's batch i, and
    the augmentation is keyed by (seed, epoch, index);
  * recalibration must leave the weights untouched, bit for bit (key 0
    against key 1), and the two sets of statistics agree elementwise
    within 1e-5 + 1e-4·|b|, the reference's bar: the moments' sums are
    grouped otherwise over two ranks, so bitwise is not expected.
Writes a JSON and exits 1 when it is not ok.
"""

from __future__ import annotations

import argparse
import re
import shutil
import tempfile
from pathlib import Path

import torch

from mnasnet_tpu_torch.tools import multihost
from mnasnet_tpu_torch.tools.multihost import pair
from mnasnet_tpu_torch.tools.dress_rehearsal import make_tree
from mnasnet_tpu_torch.tools.multihost_data import tree_flags

RECAL_BATCHES = 8
ATOL, RTOL = 1e-5, 1e-4  # tools/multihost_recal.py's bar, in fp32


def stats_vs(ours: dict, ref: dict) -> dict:
    """The BN running statistics of two model state dicts, elementwise
    within ATOL + RTOL·|ref|."""
    rows = []
    for name, b in ref.items():
        if not name.endswith(("running_mean", "running_var")):
            continue
        a64, b64 = ours[name].double(), b.double()
        diff = (a64 - b64).abs()
        rows.append({"leaf": name, "max_abs": float(diff.max()),
                     "excess": float((diff - RTOL * b64.abs()).max()),
                     "bitwise": bool(torch.equal(ours[name], b))})
    return {"stats_leaves": len(rows), "stats_bitwise_leaves": sum(r["bitwise"] for r in rows),
            "max_abs": max(r["max_abs"] for r in rows),
            "max_excess": max(r["excess"] for r in rows),
            "worst_leaves": sorted(rows, key=lambda r: -r["excess"])[:3]}


def recal_run(work, n_classes: int, image_size: int = 64, batch_size: int = 32,
              recal_batches: int = RECAL_BATCHES, timeout: float = 2400.0) -> dict:
    work = Path(work).resolve()  # the children run in the repository root
    data, ckpt, oracle = work / "data", work / "ckpt", work / "oracle"
    for d in (data, ckpt, oracle):
        shutil.rmtree(d, ignore_errors=True)
    info = make_tree(data, n_classes)
    argv = [*tree_flags(data, n_classes, image_size, batch_size), "--dtype", "float32",
            "--bn-recalibrate", str(recal_batches)]
    print("[1/2] two ranks: one epoch, then --bn-recalibrate", flush=True)
    logs = pair(argv, ckpt, work, "recal", timeout=timeout)
    m = re.search(r"bn-recalibrated: acc1=([0-9.]+)", logs[0])
    print("[2/2] one process recalibrates the epoch's checkpoint over the same global "
          "batches", flush=True)
    shutil.copytree(ckpt / "0", oracle / "0")
    multihost.run_oracle([*argv, "--output-dir", str(oracle), "--resume", str(oracle)], 2,
                         work / "oracle.log", timeout)
    before, after = multihost.payload(ckpt, 0), multihost.payload(ckpt, 1)
    ref = multihost.payload(oracle, 1)
    params = [n for n, _ in before["model"].items()
              if not n.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    untouched = [n for n in params if not torch.equal(before["model"][n], after["model"][n])]
    cmp = stats_vs(after["model"], ref["model"])
    stats_match = cmp["max_excess"] <= ATOL
    return {
        "ok": bool(stats_match and not untouched),
        "stats_match": stats_match,
        "params_bitwise_unchanged": not untouched,
        "params_mismatches": untouched[:5],
        "dtype": "float32",
        "n_processes": 2,
        "global_batches_recalibrated": recal_batches,
        "global_batch": batch_size,
        "images": info["counts"],
        "recal_val_acc1_2proc": float(m.group(1)) if m else None,
        "criterion": f"elementwise |a-b| <= {ATOL} + {RTOL}*|b|",
        "oracle": cmp,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(multihost.REPO / "build" / "multihost_recal.json"))
    ap.add_argument("--n-classes", type=int, default=200)
    ap.add_argument("--keep", default=None, help="keep the tree and the logs here")
    args = ap.parse_args(argv)
    multihost.exit_on_sigterm()
    with tempfile.TemporaryDirectory() as tmp:
        out = recal_run(args.keep or tmp, args.n_classes)
    return multihost.finish(out, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
