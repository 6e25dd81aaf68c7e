"""The port's BN forensics (``mnasnet_tpu_torch/tools/bn_forensics.py``)
against the reference's (``tools/bn_forensics.py``) on the CPU.

One small JAX state comes from the reference's ``Trainer`` (α 0.35, 32 px,
batch 8, 4 steps on the smoke's gratings at BN momentum 0.9, so that the
running statistics are off their (0, 1) init), is carried into the port
(``state_dict_from_jax``), and both replay the same numpy batches: the
reference through ``mnasnet_tpu/train/bn_recal.py``'s ``make_recal_step``
and ``_combine`` and its own formulas for within and between, the port
through the tool's ``replay`` and ``decompose``.

Tolerance: the bar of ``tests/test_torch_trainer.py``'s recalibration
comparison, 1e-5 of a value's scale plus SPREAD (4) times the reference's
own move when its images move by one ulp (times 1 + 2^-23); a train-mode
forward through 52 batch-statistic BNs carries ~1e-6 relative error per
reduction on the CPU. The scale of a buffer is its largest value, and at
least the site's largest pooled variance for a variance (pooled, within,
between) or that variance's square root for a mean: a channel whose
activations of size 1 nearly cancel has a mean of ~1e-5 whose rounding is
~1e-7, of the size of the activations, not of the mean. A share or a ratio
has a scale of at least 1. The controls' val top-1 are held exactly, their
losses within 1e-4 relative."""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnasnet_tpu import create_model as jax_create_model
from mnasnet_tpu.data.pipeline import DataLoader as JaxDataLoader
from mnasnet_tpu.data.transforms import eval_transform as jax_eval_transform
from mnasnet_tpu.data.transforms import train_transform as jax_train_transform
from mnasnet_tpu.parallel.mesh import make_mesh
from mnasnet_tpu.train.bn_recal import _combine as jax_combine
from mnasnet_tpu.train.bn_recal import make_recal_step as jax_make_recal_step
from mnasnet_tpu.train.optim import create_optimizer as jax_create_optimizer
from mnasnet_tpu.train.trainer import Trainer as JaxTrainer
from mnasnet_tpu.train.trainer import make_jit_eval_step
from mnasnet_tpu.train.trainer import run_validation as jax_run_validation
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.convert.torch_converter import (
    _layer_map,
    state_dict_from_jax,
    stats_from_jax,
)
from mnasnet_tpu_torch.data.pipeline import DataLoader
from mnasnet_tpu_torch.data.transforms import eval_transform, train_transform
from mnasnet_tpu_torch.tools import bn_forensics, train_smoke
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA, IMG, BATCH, MOMENTUM = 0.35, 32, 8, 0.9
BN_STATS = "two_pass"
NUM_BATCHES = 4
SPREAD = 4.0  # tests/test_torch_trainer.py:RECAL_SPREAD
RESULT_KEYS = {"state_file", "state_epoch", "config", "num_batches", "decomposition",
               "summary", "worst_sites_by_ema_var_deficit", "controls_val_top1", "reading"}
CONTROLS = ("ema_mean_ema_var", "pooled_mean_pooled_var", "pooled_mean_ema_var",
            "ema_mean_pooled_var")
ROW_KEYS = ("between_share_of_pooled", "ema_var_over_pooled", "ema_var_over_within")


def _load(name, path):
    """A reference tool as a module, without leaving its path entries behind."""
    before = list(sys.path)
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = before
    return module


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_tools():
    return (_load("reference_train_smoke", "tools/train_smoke.py"),
            _load("reference_bn_forensics", "tools/bn_forensics.py"))


@pytest.fixture(scope="module")
def trained(ref_tools):
    """The reference's Trainer, one epoch of 4 steps on the smoke's train
    gratings; its variables as numpy trees."""
    ref_smoke, _ = ref_tools
    model = jax_create_model("mnasnet0_35", num_classes=10, bn_momentum=MOMENTUM,
                             bn_ema="external", bn_stats=BN_STATS, precision="highest")
    mesh = make_mesh(jax.devices()[:1])
    trainer = JaxTrainer(model, jax_create_optimizer("rmsprop", 0.016), mesh=mesh,
                         print_freq=10**9, preempt_sync=False)
    loader = JaxDataLoader(ref_smoke.GratingDataset(32, IMG, seed=1), BATCH,
                           lambda img, rng: jax_train_transform(img, IMG, rng),
                           shuffle=True, drop_last=True, seed=0, workers=0)
    state = trainer.create_state(jax.random.PRNGKey(0), IMG)
    state = trainer.train_epoch(state, loader, 0)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return model, mesh, variables


def _port_model(variables):
    model = create_model("mnasnet0_35", device="cpu", num_classes=10, bn_momentum=MOMENTUM,
                         bn_ema="external", bn_stats=BN_STATS, dw_impl="kernel",
                         bn_bwd="kernel")
    model.load_state_dict(state_dict_from_jax(variables, ALPHA), strict=True)
    return model


def _train_loader():
    return DataLoader(train_smoke.GratingDataset(64, IMG, seed=1), BATCH,
                      lambda img, rng: train_transform(img, IMG, rng),
                      shuffle=True, drop_last=True, seed=0, workers=0)


def _reference_replay(model, variables, batches, scale=1.0):
    """tools/bn_forensics.py:171-192 on ``batches`` times ``scale``:
    (pooled, within, between) batch_stats trees."""
    step = jax.jit(jax_make_recal_step(model))
    stats = variables["batch_stats"]
    sum_s = jax.tree.map(jnp.zeros_like, stats)
    sum_sq = jax.tree.map(jnp.zeros_like, stats)
    for x in batches:
        x = jnp.asarray((x * np.float32(scale)).astype(np.float32))
        sum_s, sum_sq = step(variables["params"], sum_s, sum_sq, x)
    n = len(batches)
    pooled = jax.tree.map(np.asarray, jax.jit(jax_combine, static_argnums=(2,))(
        sum_s, sum_sq, n))
    within = jax.tree.map(lambda a: np.asarray(a / n), sum_s)
    between = jax.tree.map(lambda sq, s: np.maximum(np.asarray(sq) / n
                                                    - (np.asarray(s) / n) ** 2, 0.0),
                           sum_sq, sum_s)
    return pooled, within, between


def _reference_rows(flatten_stats, ema, pooled, within, between) -> dict:
    """tools/bn_forensics.py:194-213, by site path."""
    ema_f, pool_f, within_f, between_f = (flatten_stats(t) for t in (ema, pooled, within,
                                                                     between))
    rows = {}
    for site in sorted(pool_f):
        pv = pool_f[site]["var"].astype(np.float64)
        wv = within_f[site]["var"].astype(np.float64)
        bv = between_f[site]["mean"].astype(np.float64)
        ev = ema_f[site]["var"].astype(np.float64)
        rows[site] = {
            "between_share_of_pooled": float(np.median(bv / (pv + 1e-12))),
            "ema_var_over_pooled": float(np.median(ev / (pv + 1e-12))),
            "ema_var_over_within": float(np.median(ev / (wv + 1e-12))),
        }
    return rows


@pytest.fixture(scope="module")
def both(trained, ref_tools):
    model_jax, _, variables = trained
    batches = [x for x, _ in _train_loader().epoch(0)][:NUM_BATCHES]
    ref = _reference_replay(model_jax, variables, batches)
    moved = _reference_replay(model_jax, variables, batches, 1.0 + 2.0 ** -23)

    model = _port_model(variables)
    ema = bn_forensics.running_stats(model)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    sum_s, sum_sq, n = bn_forensics.replay(model, _train_loader(), NUM_BATCHES, torch.float32)
    ours = bn_forensics.decompose(sum_s, sum_sq, n)
    assert n == NUM_BATCHES
    # the replay leaves the weights and the running statistics as they were
    assert all(torch.equal(p, params[k]) for k, p in model.named_parameters())
    assert all(torch.equal(t, ema[k]) for k, t in bn_forensics.running_stats(model).items())
    return model, ema, ours, ref, moved


def _tol(r, m, scale=0.0):
    return 1e-5 * max(float(np.abs(r).max()), scale) + SPREAD * float(np.abs(m - r).max())


@pytest.mark.parametrize("part", ["pooled", "within", "between"])
def test_the_decomposition_matches_the_reference(both, part):
    _, _, ours, ref, moved = both
    i = ("pooled", "within", "between").index(part)
    r, m = stats_from_jax(ref[i], ALPHA), stats_from_jax(moved[i], ALPHA)
    if part == "between":  # Var_b[mean_b], under the means' names
        r, m = ({k: v for k, v in t.items() if k.endswith("running_mean")} for t in (r, m))
    pooled_var = stats_from_jax(ref[0], ALPHA)
    o = ours[i]
    assert o.keys() == r.keys()
    for name in r:
        var = float(pooled_var[name.rpartition(".")[0] + ".running_var"].max())
        is_var = part == "between" or name.endswith("running_var")
        tol = _tol(r[name], m[name], var if is_var else var ** 0.5)
        np.testing.assert_allclose(o[name].numpy(), r[name], rtol=0, atol=tol,
                                   err_msg=f"{part} {name}")
    if part == "pooled":
        # pooled var = within var + Var_b[mean_b], per channel, to fp32 rounding
        _, within, between = ours
        for name in o:
            if name.endswith("running_var"):
                mean = name[:-len("var")] + "mean"
                torch.testing.assert_close(o[name], within[name] + between[mean],
                                           rtol=1e-6, atol=0)


def test_the_site_medians_match_the_reference(both, trained, ref_tools):
    flatten_stats = ref_tools[1].flatten_stats
    _, ema, ours, ref, moved = both
    rows = {r["site"]: r for r in bn_forensics.site_rows(ema, *ours)}
    jax_ema = trained[2]["batch_stats"]  # the state's running statistics
    want = _reference_rows(flatten_stats, jax_ema, *ref)
    near = _reference_rows(flatten_stats, jax_ema, *moved)
    paths = {prefix: "/".join(path) for prefix, path, kind in _layer_map(ALPHA) if kind == "bn"}
    assert set(rows) == set(paths) and len(rows) == len(want)
    for site, row in rows.items():
        r, m = want[paths[site]], near[paths[site]]
        for key in ROW_KEYS:
            tol = 1e-5 * max(abs(r[key]), 1.0) + SPREAD * abs(m[key] - r[key])
            assert abs(row[key] - r[key]) <= tol, (site, key, row[key], r[key], tol)
    summary = bn_forensics.summarize(list(rows.values()))
    assert summary["sites"] == len(paths)
    for key in ROW_KEYS:
        r = float(np.median([w[key] for w in want.values()]))
        m = float(np.median([w[key] for w in near.values()]))
        assert abs(summary[f"median_{key}"] - r) <= 1e-5 * max(abs(r), 1.0) + SPREAD * abs(m - r), \
            key


def test_the_reading_is_the_reference_text(ref_tools):
    _, ref = ref_tools
    for share, ratio in ((0.2, 0.9), (1e-3, 1.2), (1e-3, 0.8)):
        summary = {"median_between_share_of_pooled": share, "median_ema_var_over_pooled": ratio}
        assert bn_forensics._reading(summary) == ref._reading(summary)


def _mix(mean_src, var_src):
    """tools/bn_forensics.py's _mix."""
    if set(mean_src) >= {"mean", "var"} and not isinstance(mean_src["mean"], dict):
        return {"mean": mean_src["mean"], "var": var_src["var"]}
    return {k: _mix(mean_src[k], var_src[k]) for k in mean_src}


def test_the_controls_match_the_reference(both, trained, ref_tools):
    """The four hybrids' val top-1 through each package's validation on 20
    val gratings (a padded tail), each side with its own pooled statistics."""
    model, ema, ours, ref, _ = both
    model_jax, mesh, variables = trained
    trainer = Trainer(model, create_optimizer("rmsprop", 0.0), device="cpu", print_freq=10**9)
    val = DataLoader(train_smoke.GratingDataset(20, IMG, seed=2), BATCH,
                     lambda img: eval_transform(img, IMG), shuffle=False, drop_last=False,
                     workers=0, augment=False)
    got = bn_forensics.controls(model, trainer, trainer.create_state(0), val, ema, ours[0])
    assert tuple(got) == CONTROLS
    assert all(torch.equal(t, ema[k]) for k, t in bn_forensics.running_stats(model).items())

    jax_val = JaxDataLoader(ref_tools[0].GratingDataset(20, IMG, seed=2), BATCH,
                            lambda img: jax_eval_transform(img, IMG), shuffle=False,
                            drop_last=False, workers=0, augment=False)
    step = make_jit_eval_step(model_jax, mesh)
    ema_tree, pooled = variables["batch_stats"], ref[0]
    for key, stats in zip(CONTROLS, (ema_tree, pooled, _mix(pooled, ema_tree),
                                     _mix(ema_tree, pooled))):
        top1, _, loss = jax_run_validation(step, variables["params"], stats, jax_val, mesh=mesh,
                                           verbose=False)
        assert got[key]["val_top1"] == round(top1, 3), key
        assert got[key]["val_loss"] == pytest.approx(loss, rel=1e-4, abs=1e-4), key


def test_the_cli_writes_the_reference_keys(tmp_path):
    """train_smoke --state-file (1 epoch), then the tool on that file."""
    state, out = tmp_path / "state.pt", tmp_path / "forensics.json"
    train_smoke.main(["--device", "cpu", "--image-size", "32", "--batch-size", "8",
                      "--train-size", "16", "--val-size", "8", "--epochs", "1", "--workers",
                      "0", "--dtype", "float32", "--json", str(tmp_path / "curve.json"),
                      "--state-file", str(state)])
    assert bn_forensics.main(["--state-file", str(state), "--device", "cpu", "--num-batches",
                              "2", "--json", str(out)]) == 0
    result = json.loads(out.read_text())
    assert RESULT_KEYS <= set(result)
    assert result["state_epoch"] == 1 and result["num_batches"] == 2
    assert result["summary"]["sites"] == 52 and len(result["worst_sites_by_ema_var_deficit"]) == 5
    assert tuple(result["controls_val_top1"]) == CONTROLS
    assert result["config"]["bn_momentum"] == 0.9 and result["card"] is None
