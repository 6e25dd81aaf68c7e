"""The PyTorch port's Trainer, checkpoints and BN recalibration, on the CPU
(the kernels' plain versions), against the JAX package where it has a
counterpart. Configuration: alpha 0.35, 32 px, batch 8, 8 classes, fp32.

Tolerances: the port's own paths (train_epoch against the bare step,
checkpoint round trips, stop and resume, EMA validation) are held bit for
bit. Against JAX: validation's top-1/top-5 counts exactly and its loss
within 1e-5 relative; the pooling of recalibration within 1e-6 on identical
statistics, and the recalibrated statistics end to end within 1e-5 of each
buffer's largest value plus a multiple of the reference's own one-ulp
spread (see test_recalibrate_bn_matches_jax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnasnet_tpu.convert import torch_converter as jax_conv
from mnasnet_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from mnasnet_tpu.data.pipeline import DataLoader as JaxDataLoader
from mnasnet_tpu.data.transforms import eval_transform as jax_eval_transform
from mnasnet_tpu.data.transforms import train_transform as jax_train_transform
from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.parallel.mesh import make_mesh
from mnasnet_tpu.train.bn_recal import recalibrate_bn as jax_recalibrate_bn
from mnasnet_tpu.train.trainer import make_jit_eval_step
from mnasnet_tpu.train.trainer import run_validation as jax_run_validation
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.convert.torch_converter import stats_from_jax
from mnasnet_tpu_torch.data.dataset import SyntheticDataset
from mnasnet_tpu_torch.data.pipeline import DataLoader
from mnasnet_tpu_torch.data.transforms import eval_transform, train_transform
from mnasnet_tpu_torch.train.bn_recal import recalibrate_bn
from mnasnet_tpu_torch.train.checkpoint import CheckpointManager
from mnasnet_tpu_torch.train.optim import create_optimizer, get_ema_params
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_train_step
from mnasnet_tpu_torch.train.trainer import Trainer

ALPHA, IMG, BATCH, CLASSES = 0.35, 32, 8, 8
# Multiple of the reference's own one-ulp spread allowed for the recalibrated
# statistics (test_recalibrate_bn_matches_jax).
RECAL_SPREAD = 4.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0, **kw):
    kw = {"dw_impl": "kernel", "bn_bwd": "kernel", **kw}
    return create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, seed=seed, **kw)


def _perturb_stats(model, seed=1):
    """BN statistics and affines away from their init, so that eval-mode
    activations do not vanish and logits tell classes apart."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    return model


def _train_loader(n=24, workers=0):
    return DataLoader(SyntheticDataset(n, IMG, CLASSES, seed=0), BATCH,
                      lambda img, rng: train_transform(img, IMG, rng),
                      shuffle=True, drop_last=True, seed=0, workers=workers)


def _val_loader(n=20):
    return DataLoader(SyntheticDataset(n, IMG, CLASSES, seed=1), BATCH,
                      lambda img: eval_transform(img, IMG),
                      shuffle=False, drop_last=False, workers=0, augment=False)


def _run(opt="rmsprop", model_ema=None, **model_kw):
    model = _model(**model_kw)
    tx = create_optimizer(opt, 1e-3, fused="small", model_ema=model_ema)
    trainer = Trainer(model, tx, device="cpu", label_smoothing=0.1, print_freq=1000)
    return model, tx, trainer, trainer.create_state(0)


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def _assert_same_run(m1, tx1, s1, m2, tx2, s2):
    _assert_tree_equal(m1.state_dict(), m2.state_dict())
    _assert_tree_equal(tx1.state_dict(), tx2.state_dict())
    _assert_tree_equal(s1.state_dict(), s2.state_dict())


def test_train_epoch_equals_the_bare_step():
    """Trainer.train_epoch (loader, prefetch, late metrics) changes nothing
    of what make_train_step computes on the same batches."""
    loader = _train_loader(workers=2)
    m1, tx1, trainer, s1 = _run(bn_ema="external", stem_s2d=True)
    s1 = trainer.train_epoch(s1, loader, 0)
    s1 = trainer.train_epoch(s1, loader, 1)
    assert s1.step == 6 and not trainer.stopped_early
    assert np.isfinite(trainer.epoch_train_stats["loss"])

    m2 = _model(bn_ema="external", stem_s2d=True)
    tx2 = create_optimizer("rmsprop", 1e-3, fused="small")
    s2 = TrainState.create(m2, tx2, seed=0)
    step = make_train_step(m2, tx2, 0.1)
    for epoch in (0, 1):
        for images, labels in loader.epoch(epoch):
            s2, _ = step(s2, torch.from_numpy(images), torch.from_numpy(labels))
    _assert_same_run(m1, tx1, s1, m2, tx2, s2)


def _jax_variables(model):
    v = jax_conv.torch_to_flax(model.state_dict(), ALPHA)
    return jax.tree.map(jnp.asarray, v)


def test_validate_matches_jax_run_validation():
    """20 images at batch 8: the third batch has 4 real samples and 4 padded
    ones with label -1, which count nowhere."""
    model = _perturb_stats(_model())
    tx = create_optimizer("rmsprop", 1e-3)
    trainer = Trainer(model, tx, device="cpu", print_freq=1000)
    acc1, acc5, loss = trainer.validate(trainer.create_state(0), _val_loader(), verbose=False)

    jax_loader = JaxDataLoader(JaxSynthetic(20, IMG, CLASSES, seed=1), BATCH,
                               lambda img: jax_eval_transform(img, IMG), shuffle=False,
                               drop_last=False, workers=0, augment=False)
    mesh = make_mesh(jax.devices()[:1])
    jax_model = JaxMNASNet(alpha=ALPHA, num_classes=CLASSES, precision="highest")
    v = _jax_variables(model)
    ref = jax_run_validation(make_jit_eval_step(jax_model, mesh), v["params"],
                             v["batch_stats"], jax_loader, mesh=mesh, verbose=False)
    assert (acc1, acc5) == (ref[0], ref[1])
    assert 0 < acc1 < 100  # the logits tell the classes apart
    assert loss == pytest.approx(ref[2], rel=1e-5)


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Parameters, BN buffers, the optimizer with its model EMA, the dropout
    generator and the step all come back; the next step is then the same."""
    loader = _train_loader()
    m1, tx1, trainer, s1 = _run(model_ema=0.9)
    s1 = trainer.train_epoch(s1, loader, 0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, m1, tx1, s1, acc1=12.5, best_acc1=12.5, is_best=True)

    m2 = _model(seed=7)
    tx2 = create_optimizer("rmsprop", 1e-3, fused="small", model_ema=0.9)
    s2 = TrainState.create(m2, tx2, seed=9)
    assert CheckpointManager(str(tmp_path)).restore(m2, tx2, s2) == (1, 12.5)
    _assert_same_run(m1, tx1, s1, m2, tx2, s2)
    images, labels = (torch.from_numpy(a) for a in next(loader.epoch(3)))
    s1, _ = make_train_step(m1, tx1, 0.1)(s1, images, labels)
    s2, _ = make_train_step(m2, tx2, 0.1)(s2, images, labels)
    _assert_same_run(m1, tx1, s1, m2, tx2, s2)

    with pytest.raises(ValueError, match="fields"):
        CheckpointManager(str(tmp_path)).restore(
            _model(), create_optimizer("rmsprop", 1e-3), TrainState.create(_model(), tx2))


def test_latest_n_best_and_restore_variables(tmp_path):
    m, tx, trainer, s = _run(model_ema=0.5)
    s = trainer.train_epoch(s, _train_loader(16), 0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_epoch() is None and mgr.best_epoch() is None
    best = 0.0
    for epoch, acc1 in enumerate([10.0, 30.0, 20.0, 25.0, 5.0]):
        is_best = acc1 > best
        best = max(best, acc1)
        mgr.save(epoch, m, tx, s, acc1, best, is_best=is_best)
    (tmp_path / ".tmp-9-1").mkdir()  # a torn write is no checkpoint
    assert mgr.keys() == [3, 4] and mgr.latest_epoch() == 4
    assert mgr.best_epoch() == 1 and mgr._best.keys() == [1]

    sd, epoch, best_acc1 = mgr.restore_variables()
    assert (epoch, best_acc1) == (4, 30.0)
    _assert_tree_equal(sd, m.state_dict())
    assert mgr.restore_variables(best=True)[1] == 1
    sd_ema, _, _ = mgr.restore_variables(use_ema=True)
    ema = get_ema_params(tx)
    for name, t in m.state_dict().items():
        assert torch.equal(sd_ema[name], ema[name] if name in ema else t)
    assert any(not torch.equal(ema[n], p) for n, p in m.named_parameters())

    plain = CheckpointManager(str(tmp_path / "plain"))
    m2, tx2, _, s2 = _run()
    plain.save(0, m2, tx2, s2, 0.0, 0.0)
    with pytest.raises(ValueError, match="model-EMA"):
        plain.restore_variables(use_ema=True)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_variables()
    assert not (tmp_path / "empty").exists()


def test_stop_then_resume_is_bitwise(tmp_path):
    """Stopped after step 2 of epoch 0 (3 steps per epoch), saved, restored
    into fresh objects and resumed at that step: the same as two
    uninterrupted epochs, on every piece of state."""
    m_a, tx_a, trainer_a, s_a = _run(model_ema=0.9, bn_ema="external", stem_s2d=True)
    for epoch in (0, 1):
        s_a = trainer_a.train_epoch(s_a, _train_loader(), epoch)

    m_b, tx_b, trainer_b, s_b = _run(model_ema=0.9, bn_ema="external", stem_s2d=True)
    s_b = trainer_b.train_epoch(s_b, _train_loader(), 0,
                                step_callback=lambda s, g: trainer_b.request_stop(),
                                step_callback_freq=2)
    assert trainer_b.stopped_early and trainer_b.next_global_step == 2 and s_b.step == 2
    # Sticky, and the first stop wins.
    s_b = trainer_b.train_epoch(s_b, _train_loader(), 1)
    assert trainer_b.stopped_early and trainer_b.next_global_step == 2 and s_b.step == 2
    CheckpointManager(str(tmp_path), track_best=False).save(2, m_b, tx_b, s_b, 0.0, 0.0)

    m_c, tx_c, trainer_c, s_c = _run(model_ema=0.9, bn_ema="external", stem_s2d=True)
    CheckpointManager(str(tmp_path), track_best=False).restore(m_c, tx_c, s_c)
    epoch, start = divmod(2, _train_loader().steps_per_epoch())
    s_c = trainer_c.train_epoch(s_c, _train_loader(), epoch, start_step=start)
    s_c = trainer_c.train_epoch(s_c, _train_loader(), 1)
    _assert_same_run(m_a, tx_a, s_a, m_c, tx_c, s_c)


class _Scaled:
    """A loader whose images are multiplied by ``scale``: 1 + 2**-23 moves
    every pixel by about one ulp."""

    drop_last = True

    def __init__(self, loader, scale):
        self.loader, self.scale = loader, np.float32(scale)

    def epoch(self, epoch):
        for x, y in self.loader.epoch(epoch):
            yield (x * self.scale).astype(np.float32), y


@pytest.mark.parametrize("bn_ema", ["external", "module"])
def test_recalibrate_bn_matches_jax(bn_ema):
    """Three batches through both packages' recalibration. A 1e-5 relative
    bound is below the reference's own spread here: a one-ulp change of its
    input moves its pooled statistics by up to 2.3e-5 of a buffer's largest
    value (the train-mode forward through 50 batch-statistic BNs, whose CPU
    reductions carry ~1e-6 relative error each). So each buffer is held to
    1e-5 of its largest value plus SPREAD times the reference's own move;
    the pooling itself is held to 1e-6 on identical statistics by
    test_pooled_moments_match_jax."""
    model = _perturb_stats(_model(bn_ema=bn_ema, bn_stats="two_pass"))
    variables = _jax_variables(model)
    tracked = {n: t.clone() for n, t in model.state_dict().items()
               if n.endswith("num_batches_tracked")}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    new = recalibrate_bn(model, _train_loader(32), num_batches=3, verbose=False)

    jax_model = JaxMNASNet(alpha=ALPHA, num_classes=CLASSES, bn_ema=bn_ema,
                           bn_stats="two_pass", precision="highest")
    jax_loader = JaxDataLoader(JaxSynthetic(32, IMG, CLASSES, seed=0), BATCH,
                               lambda img, rng: jax_train_transform(img, IMG, rng),
                               shuffle=True, drop_last=True, seed=0, workers=0)
    ref, moved = (stats_from_jax(jax.tree.map(np.asarray, jax_recalibrate_bn(
        jax_model, variables["params"], variables["batch_stats"], _Scaled(jax_loader, scale),
        mesh=make_mesh(jax.devices()[:1]), num_batches=3, verbose=False)), ALPHA)
        for scale in (1.0, 1.0 + 2.0 ** -23))
    sd = model.state_dict()
    assert new.keys() == ref.keys()
    for name, r in ref.items():
        assert torch.equal(new[name], sd[name])
        tol = 1e-5 * float(np.abs(r).max()) + RECAL_SPREAD * float(np.abs(moved[name] - r).max())
        np.testing.assert_allclose(sd[name].numpy(), r, rtol=0, atol=tol, err_msg=name)
    _assert_tree_equal({n: sd[n] for n in tracked}, tracked)
    _assert_tree_equal({n: p.detach() for n, p in model.named_parameters()}, params)
    assert not model.training


def test_pooled_moments_match_jax():
    """var = E[v_b] + Var[m_b] on identical per-batch statistics."""
    from mnasnet_tpu.train.bn_recal import _combine as jax_combine

    from mnasnet_tpu_torch.train.bn_recal import _combine

    batches = [_perturb_stats(_model(), seed=s).state_dict() for s in range(3)]
    names = [n for n in batches[0] if n.endswith(("running_mean", "running_var"))]
    sum_s = {n: sum(b[n] for b in batches) for n in names}
    sum_sq = {n: sum(b[n] * b[n] for b in batches) for n in names}
    ours = _combine(sum_s, sum_sq, 3)
    trees = [jax_conv.torch_to_flax(b, ALPHA)["batch_stats"] for b in batches]
    ref = jax_combine(jax.tree.map(lambda *a: sum(a), *trees),
                      jax.tree.map(lambda *a: sum(x * x for x in a), *trees), 3)
    ref = stats_from_jax(jax.tree.map(np.asarray, ref), ALPHA)
    assert ours.keys() == ref.keys()
    for name, r in ref.items():
        np.testing.assert_allclose(ours[name].numpy(), r, rtol=1e-6, atol=1e-7, err_msg=name)
    between = {n: ours[n] - sum_s[n] / 3 for n in names if n.endswith("var")}
    assert all((v >= 0).all() for v in between.values())
    assert any((v > 1e-3).any() for v in between.values())


def test_recalibrate_bn_refuses_a_padded_loader():
    loader = DataLoader(SyntheticDataset(12, IMG, CLASSES), BATCH,
                        lambda img, rng: train_transform(img, IMG, rng), drop_last=False)
    with pytest.raises(ValueError, match="drop_last"):
        recalibrate_bn(_model(), loader, num_batches=1)


def test_ema_validation_scores_the_ema_weights():
    """validate(params_override=EMA) scores what a model holding the EMA
    weights scores, through the fused MBConv route whose wrapper folds BN
    from the module's own parameters, and leaves the raw weights as they
    were."""
    m, tx, trainer, s = _run(model_ema=0.5)
    _perturb_stats(m)
    s = trainer.train_epoch(s, _train_loader(), 0)
    _perturb_stats(m)
    raw = {n: p.detach().clone() for n, p in m.named_parameters()}
    ema = get_ema_params(tx)
    scored = trainer.validate(s, _val_loader(), verbose=False, params_override=ema)
    _assert_tree_equal({n: p.detach() for n, p in m.named_parameters()}, raw)

    holder = _model()
    holder.load_state_dict({**m.state_dict(), **ema})
    expected = Trainer(holder, create_optimizer("sgd", 0.1), device="cpu").validate(
        None, _val_loader(), verbose=False)
    assert scored == expected
    assert trainer.validate(s, _val_loader(), verbose=False)[2] != scored[2]


def test_meters_print_as_the_reference(capsys):
    from mnasnet_tpu.utils import meters as jax_meters

    from mnasnet_tpu_torch.utils import meters

    lines = []
    for mod in (meters, jax_meters):
        m = [mod.AverageMeter("Loss", ":.4e"), mod.AverageMeter("Acc@1", ":6.2f")]
        for v, n in ((2.5, 8), (1.25, 4)):
            m[0].update(torch.tensor(v), n)
            m[1].update(v * 10, n)
        mod.ProgressMeter(120, m, prefix="Epoch: [3]").display(7)
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] == (
        "Epoch: [3][  7/120]\tLoss 1.2500e+00 (2.0833e+00)\tAcc@1  12.50 ( 20.83)\n")
