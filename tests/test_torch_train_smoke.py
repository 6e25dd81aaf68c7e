"""The port's convergence smoke (``mnasnet_tpu_torch/tools/train_smoke.py``),
the counterpart of ``tools/train_smoke.py``, on the CPU: its dataset renders
the reference tool's gratings bit for bit (the reference tool imported as the
oracle), and a two-step run at α 0.35 and 32 px writes the curve with the
reference's keys and exits non-zero below its target."""

import importlib.util
import json
import os

import numpy as np
import pytest

from mnasnet_tpu_torch.tools import train_smoke

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
               "grad_accum", "bn_momentum", "warmup_epochs", "bn_recalibrate", "eval_every"}


def _reference_tool():
    spec = importlib.util.spec_from_file_location("reference_train_smoke",
                                                  os.path.join(REPO, "tools", "train_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("image_size,seed", [(96, 1), (32, 2)])
def test_grating_dataset_is_the_reference_bit_for_bit(image_size, seed):
    ref = _reference_tool().GratingDataset(40, image_size, seed=seed)
    ours = train_smoke.GratingDataset(40, image_size, seed=seed)
    assert len(ours) == len(ref) and ours.classes == ref.classes
    for i in (0, 1, 9, 10, 39):
        (a, la), (b, lb) = ours.load(i), ref.load(i)
        assert la == lb and a.size == b.size
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _run(tmp_path, *extra):
    out = tmp_path / "curve.json"
    rc = train_smoke.main(["--device", "cpu", "--arch", "mnasnet0_35", "--image-size", "32",
                           "--batch-size", "8", "--train-size", "16", "--val-size", "8",
                           "--epochs", "1", "--workers", "0", "--dtype", "float32",
                           "--json", str(out), *extra])
    return rc, json.loads(out.read_text())


def test_two_step_run_writes_the_reference_keys(tmp_path):
    rc, result = _run(tmp_path, "--bn-recalibrate")
    assert rc == (0 if result["reached_target"] else 1)
    assert RESULT_KEYS <= set(result) and set(result["recipe"]) == RECIPE_KEYS
    # the port's own flags beside the reference's: --device and --seed
    assert set(result["config"]) == CONFIG_KEYS | {"device", "seed"}
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
