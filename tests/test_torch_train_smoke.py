"""The port's convergence smoke (``mnasnet_tpu_torch/tools/train_smoke.py``),
the counterpart of ``tools/train_smoke.py``, on the CPU: its dataset renders
the reference tool's gratings bit for bit, cached or not (the reference tool
imported as the oracle); a two-step run at α 0.35 and 32 px writes the curve
with the reference's keys and exits non-zero below its target; a run chunked
through exit code 3 equals the straight run bit for bit; a state file of
another run is refused; the clean train re-score is ``Trainer.validate`` over
the first N train images through the eval transform."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mnasnet_tpu_torch.tools import train_smoke
from mnasnet_tpu_torch.tools.multihost import bitwise_diff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# What the reference writes (tools/train_smoke.py:dump_artifact and its curve
# rows; the diagnostics are the Trainer's epoch extrema).
RESULT_KEYS = {"task", "config", "recipe", "total_steps", "completed", "curve",
               "reached_target_evalmode", "reached_target_evalmode_recal", "reached_target",
               "wall_seconds", "backend"}
RECIPE_KEYS = {"label_smoothing", "bn_ema", "bn_ema_note", "wd", "warmup_epochs",
               "optimizer_semantics"}
ROW_KEYS = {"epoch", "step", "bn_init_retention", "train_loss", "train_top1",
            "train_top1_evalmode", "train_loss_evalmode", "val_top1", "val_loss", "lr",
            "max_grad_norm", "max_update_norm", "max_max_abs_logit", "final_param_norm",
            "final_loss"}
CONFIG_KEYS = {"arch", "image_size", "optimizer", "lr_schedule", "epochs", "batch_size",
               "train_size", "val_size", "workers", "dtype", "target_top1", "model_ema",
               "grad_accum", "bn_momentum", "warmup_epochs", "bn_recalibrate", "eval_every",
               "state_file", "chunk_epochs", "train_rescore_size"}


def _reference_tool():
    spec = importlib.util.spec_from_file_location("reference_train_smoke",
                                                  os.path.join(REPO, "tools", "train_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cache", [False, True], ids=["uncached", "cached"])
@pytest.mark.parametrize("image_size,seed", [(96, 1), (32, 2)])
def test_grating_dataset_is_the_reference_bit_for_bit(image_size, seed, cache):
    """Each image twice (the second from the cache when it is on), against
    the reference's dataset with its own cache set alike, and against the
    port's uncached one."""
    ref = _reference_tool().GratingDataset(40, image_size, seed=seed, cache=cache)
    ours = train_smoke.GratingDataset(40, image_size, seed=seed, cache=cache)
    plain = train_smoke.GratingDataset(40, image_size, seed=seed)
    assert len(ours) == len(ref) and ours.classes == ref.classes
    for _ in range(2):
        for i in (0, 1, 9, 10, 39):
            (a, la), (b, lb), (c, lc) = ours.load(i), ref.load(i), plain.load(i)
            assert la == lb == lc and a.size == b.size
            assert np.array_equal(np.asarray(a), np.asarray(b))
            assert np.array_equal(np.asarray(a), np.asarray(c))
    assert (ours._cache is not None and len(ours._cache) == 5) == cache


SMALL = ["--device", "cpu", "--arch", "mnasnet0_35", "--image-size", "32", "--batch-size", "8",
         "--train-size", "16", "--val-size", "8", "--workers", "0", "--dtype", "float32"]


def _run(tmp_path, *extra, name="curve.json", epochs="1"):
    out = tmp_path / name
    rc = train_smoke.main([*SMALL, "--epochs", epochs, "--json", str(out), *extra])
    return rc, json.loads(out.read_text())


def test_two_step_run_writes_the_reference_keys(tmp_path):
    rc, result = _run(tmp_path, "--bn-recalibrate")
    assert rc == (0 if result["reached_target"] else 1)
    assert RESULT_KEYS <= set(result) and set(result["recipe"]) == RECIPE_KEYS
    # the port's own flags beside the reference's: --device, --seed, --deterministic
    assert set(result["config"]) == CONFIG_KEYS | {"device", "seed", "deterministic"}
    assert result["total_steps"] == 2 and result["completed"] and result["backend"] == "cpu"
    (row,) = result["curve"]
    assert ROW_KEYS | {"val_top1_recal", "val_loss_recal"} <= set(row)
    assert row["step"] == 2 and np.isfinite(row["train_loss"])
    assert result["val_top1_recal"] == row["val_top1_recal"]


def test_the_exit_code_follows_the_target(tmp_path):
    rc, result = _run(tmp_path, "--target-top1", "101")
    assert rc == 1 and not result["reached_target"]
    rc, result = _run(tmp_path, "--target-top1", "0")
    assert rc == 0 and result["reached_target"]


# A recipe whose state has every part: the model EMA, recalibrated scores
# and the clean re-score; 2 steps an epoch.
LONG = ["--model-ema", "0.999", "--bn-recalibrate", "--train-rescore-size", "8",
        "--deterministic"]


def _without_wall(result):
    return {k: v for k, v in result.items() if k != "wall_seconds"}


def test_a_chunked_run_equals_the_straight_run_bit_for_bit(tmp_path):
    """1 + 1 epochs through exit code 3 and a fresh call of main, against 2
    epochs straight: the state files' tensors (model, optimizer, train
    state), their curves, and the written curve but for the wall clock."""
    straight, chunked = tmp_path / "straight.pt", tmp_path / "chunked.pt"
    rc, ref = _run(tmp_path, *LONG, "--state-file", str(straight), name="s.json", epochs="2")
    assert ref["completed"]
    chunk = [*LONG, "--state-file", str(chunked), "--chunk-epochs", "1"]
    rc1, partial = _run(tmp_path, *chunk, name="c.json", epochs="2")
    assert rc1 == 3 and not partial["completed"] and len(partial["curve"]) == 1
    rc2, ours = _run(tmp_path, *chunk, name="c.json", epochs="2")
    assert rc2 == rc and rc2 in (0, 1)
    a, b = (train_smoke.load_state(str(p)) for p in (chunked, straight))
    assert a["next_epoch"] == b["next_epoch"] == 2
    assert not bitwise_diff({k: a[k] for k in ("model", "optimizer", "train_state", "curve")},
                            {k: b[k] for k in ("model", "optimizer", "train_state", "curve")})
    assert all(torch.is_tensor(t) and t.device.type == "cpu" for t in a["model"].values())
    assert _without_wall(ours) == {**_without_wall(ref), "config": ours["config"]}
    assert {k: v for k, v in ours["config"].items() if k not in ("state_file", "chunk_epochs")} \
        == {k: v for k, v in ref["config"].items() if k not in ("state_file", "chunk_epochs")}


@pytest.mark.parametrize("flag,value", [("--seed", "1"), ("--bn-momentum", "0.99")])
def test_a_state_file_of_another_run_is_refused(tmp_path, capsys, flag, value):
    state = tmp_path / "state.pt"
    _run(tmp_path, "--state-file", str(state))
    before = state.read_bytes()
    capsys.readouterr()
    rc = train_smoke.main([*SMALL, "--epochs", "1", "--json", str(tmp_path / "other.json"),
                           "--state-file", str(state), flag, value])
    err = capsys.readouterr().err
    assert rc != 0 and "saved:" in err and "this:" in err
    key = flag[2:].replace("-", "_")
    default = train_smoke.parse_args([])
    assert f'"{key}": {json.dumps(getattr(default, key))}' in err
    assert f'"{key}": {json.dumps(type(getattr(default, key))(value))}' in err
    assert state.read_bytes() == before and not (tmp_path / "other.json").exists()


@pytest.mark.parametrize("size", [8, 5])
def test_the_train_rescore_is_validate_over_the_first_train_images(tmp_path, size):
    """--train-rescore-size N: the curve's eval-mode train scores equal
    Trainer.validate of the saved weights and statistics over the first N
    train images (seed 1) through the eval transform, unshuffled, in
    batches of 8 (N = 5: a padded tail, masked)."""
    from mnasnet_tpu_torch import create_model
    from mnasnet_tpu_torch.data.pipeline import DataLoader
    from mnasnet_tpu_torch.data.transforms import eval_transform
    from mnasnet_tpu_torch.train.optim import create_optimizer
    from mnasnet_tpu_torch.train.trainer import Trainer

    state = tmp_path / "state.pt"
    _, result = _run(tmp_path, "--train-rescore-size", str(size), "--state-file", str(state))
    saved = train_smoke.load_state(str(state))
    model = create_model("mnasnet0_35", device="cpu", num_classes=10, bn_ema="external")
    model.load_state_dict(saved["model"])
    trainer = Trainer(model, create_optimizer("rmsprop", 0.0), device="cpu", print_freq=1000)
    loader = DataLoader(train_smoke.GratingDataset(size, 32, seed=1), 8,
                        lambda img: eval_transform(img, 32), shuffle=False, drop_last=False,
                        workers=0, augment=False)
    top1, _, loss = trainer.validate(trainer.create_state(0), loader, verbose=False)
    (row,) = result["curve"]
    assert row["train_top1_evalmode"] == round(top1, 3)
    assert row["train_loss_evalmode"] == round(loss, 4)
    assert result["config"]["train_rescore_size"] == size
