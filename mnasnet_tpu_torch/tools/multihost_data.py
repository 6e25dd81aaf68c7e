"""Two ranks of the port's train CLI over an on-disk JPEG tree: the
counterpart of ``tools/multihost_data.py``.

    python -m mnasnet_tpu_torch.tools.multihost_data [--n-classes 1000]
        [--out build/multihost_data.json]

The dress rehearsal's tree (``dress_rehearsal.make_tree``: two train and one
val JPEG a class, and one CMYK file that the native decoder refuses) goes
through one epoch of two ranks with the ``native-fast`` decoder, each rank
logging the indices it consumes (``MNASNET_TPU_CONSUMED_LOG``,
``data/pipeline.py``). It holds:
  * train: each rank consumes each of its indices once, the ranks'
    indices are disjoint, and only the ``drop_last`` tail (fewer than a
    global batch) is left out;
  * val: the ranks' real samples (without the wrap-padding) cover every
    file exactly once;
  * the ranks' decoder-fallback counts sum to exactly 1 (the CMYK file);
  * a second run is bit for bit the first (model, optimizer, step and
    dropout generator of the final checkpoint).
Writes a JSON with the reference's keys and exits 1 when it is not ok. The
native decoder must be available.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path

from mnasnet_tpu_torch.tools import multihost
from mnasnet_tpu_torch.tools.dress_rehearsal import fallbacks, make_tree

CONSUMED_ENV = "MNASNET_TPU_CONSUMED_LOG"


def tree_flags(data, n_classes: int, image_size: int = 64, batch_size: int = 32,
               arch: str = "mnasnet0_5") -> list:
    """The reference's recipe over an on-disk tree: ``--deterministic``,
    SGD at a constant 1e-4, the ``native-fast`` decoder, one epoch."""
    return [str(data), "--deterministic", "--arch", arch, "--image-size", str(image_size),
            "--num-classes", str(n_classes), "--batch-size", str(batch_size),
            "--optimizer", "sgd", "--lr", "1e-4", "--lr-schedule", "constant",
            "--warmup-epochs", "0", "--workers", "2", "--print-freq", "20",
            "--decoder", "native-fast", "--epochs", "1"]


def check_consumed(logs: list, n_train: int, n_val: int, global_batch: int) -> dict:
    """The sampler's contract over the ranks' consumed-index logs."""
    train, val = [], []
    for path in logs:
        t, v = [], []
        for line in Path(path).read_text().splitlines():
            rec = json.loads(line)
            if rec["n"] == n_train:
                t.extend(rec["indices"])
            elif rec["n"] == n_val:
                k = rec["n_valid"]
                v.extend(rec["indices"][:len(rec["indices"]) if k is None else k])
            else:
                raise ValueError(f"a batch of a dataset of {rec['n']} samples")
        train.append(t)
        val.append(v)
    unique = all(len(set(t)) == len(t) for t in train)
    disjoint = not set(train[0]) & set(train[1])
    consumed = set(train[0]) | set(train[1])
    dropped = set(range(n_train)) - consumed
    tail_ok = len(dropped) < global_batch and consumed <= set(range(n_train))
    val_once = sorted(val[0] + val[1]) == list(range(n_val))
    return {"train_consumed": len(consumed), "train_dropped_tail": len(dropped),
            "train_unique_within_ranks": unique, "train_disjoint_across_ranks": disjoint,
            "train_tail_ok": tail_ok, "val_seen_exactly_once": val_once, "val_files": n_val,
            "ok": unique and disjoint and tail_ok and val_once}


def data_run(work, n_classes: int, image_size: int = 64, batch_size: int = 32,
             timeout: float = 2400.0) -> dict:
    from mnasnet_tpu_torch.data import native_decoder

    if not native_decoder.available():
        raise SystemExit("the native decoder is unavailable "
                         f"({native_decoder.unavailable_reason}): the fallback cannot fire")
    work = Path(work).resolve()  # the children run in the repository root
    data = work / "data"
    shutil.rmtree(data, ignore_errors=True)
    info = make_tree(data, n_classes)
    argv = tree_flags(data, n_classes, image_size, batch_size)
    consumed = {}
    for tag in ("a", "b"):
        shutil.rmtree(work / tag, ignore_errors=True)
        consumed[tag] = [work / f"consumed_{tag}.rank{r}.jsonl" for r in range(2)]
        for path in consumed[tag]:
            path.unlink(missing_ok=True)
        print(f"[{'ab'.index(tag) + 1}/2] two ranks over the tree", flush=True)
        with multihost.Ranks([*argv, "--output-dir", str(work / tag)], 2, work, tag,
                             rank_env=lambda r, c=consumed[tag]: {CONSUMED_ENV: str(c[r])}
                             ) as ranks:
            ranks.wait(timeout)
            if tag == "a":
                logs = [ranks.read(r) for r in range(2)]
    sampler = check_consumed(consumed["a"], info["counts"]["train"], info["counts"]["val"],
                             batch_size)
    fb = sum(fallbacks(text) for text in logs)
    diff = multihost.state_diff(multihost.payload(work / "a"), multihost.payload(work / "b"))
    return {
        "ok": bool(sampler["ok"] and fb == 1 and not diff),
        "n_processes": 2,
        "n_classes": n_classes,
        "images": info["counts"],
        "decoder": "native-fast (the C++ decoder, PIL per image where it fails)",
        "files_seen_once": sampler,
        "cmyk_fallback_total_across_ranks": fb,
        "rerun_bitwise_identical": not diff,
        "mismatches": diff[:10],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(multihost.REPO / "build" / "multihost_data.json"))
    ap.add_argument("--n-classes", type=int, default=1000)
    ap.add_argument("--keep", default=None, help="keep the tree and the logs here")
    args = ap.parse_args(argv)
    multihost.exit_on_sigterm()
    with tempfile.TemporaryDirectory() as tmp:
        out = data_run(args.keep or tmp, args.n_classes)
    return multihost.finish(out, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
