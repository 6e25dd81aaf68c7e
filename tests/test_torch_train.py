"""The PyTorch port's training step against JAX ``make_train_step``.

One set of seeded JAX weights (BN affine perturbed with numpy) goes into both
packages through ``state_dict_from_jax``; the same numpy batch goes through
the jitted JAX step and the port's step, on the port's ``kernel`` route (the
kernels' plain versions on the CPU) and its ``torch`` route. Configuration:
alpha 0.35, 64 px, batch 16, 8 classes, dropout 0, fp32, JAX
``precision="highest"``, two-pass BN statistics. Each JAX variant is jitted
once per module.

Tolerance. At random init the gradients of this batch-statistic BN network
are ill-conditioned: a rounding difference of 1e-6 flips ReLU masks and
moves some BN-scale gradients by percents. The reference's CPU reductions
carry about 1e-6 relative error (the port's about 1e-7, both against
float64), and a one-ulp change of the reference's own input moves its
gradients by up to 1.2% (at 32 px, batch 8, its 5-step RMSProp trajectory
moves by 40% of the update). So each quantity is held to the tolerance of
tests/test_bn_bwd.py:115-130 (rtol 5e-3, atol 1e-4) plus SPREAD times the
reference's own move when its images change by one ulp, and the configuration
is the larger, better-conditioned one above with small learning rates. The
optimizer's arithmetic is held exactly, on identical gradients, against
optax (:func:`test_optimizer_matches_optax_on_the_same_grads`).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.train.optim import backbone_frozen_mask as jax_frozen_mask
from mnasnet_tpu.train.optim import create_optimizer as jax_create_optimizer
from mnasnet_tpu.train.optim import get_ema_params as jax_get_ema_params
from mnasnet_tpu.train.optim import unpack_flat
from mnasnet_tpu.train.schedules import make_schedule as jax_make_schedule
from mnasnet_tpu.train.state import TrainState as JaxTrainState
from mnasnet_tpu.train.steps import auto_grad_accum as jax_auto_grad_accum
from mnasnet_tpu.train.steps import make_train_step as jax_make_train_step
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.convert.torch_converter import (
    params_from_jax,
    params_to_jax,
    state_dict_from_jax,
    stats_from_jax,
)
from mnasnet_tpu_torch.train.optim import (
    backbone_frozen_mask,
    create_optimizer,
    get_ema_params,
)
from mnasnet_tpu_torch.train.schedules import make_schedule
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import auto_grad_accum, make_train_step

ALPHA, IMAGE, BATCH, CLASSES = 0.35, 64, 16, 8
# Multiple of the reference's one-ulp spread allowed; the largest multiple
# measured over all leaves and variants was 17 (SGD traces of late BN biases).
SPREAD = 25.0


# name -> (model kwargs, optimizer kwargs, grad_accum, steps)
VARIANTS = {
    "rmsprop_s2d": (dict(bn_ema="external", stem_s2d=True),
                    dict(name="rmsprop", learning_rate=1e-4, fused="small"), 1, 5),
    "sgd": (dict(), dict(name="sgd", learning_rate=1e-4), 1, 2),
    "model_ema": (dict(), dict(name="rmsprop", learning_rate=1e-4, model_ema=0.9), 1, 2),
    "accum2": (dict(bn_ema="external"), dict(name="rmsprop", learning_rate=1e-4), 2, 2),
    "freeze": (dict(), dict(name="rmsprop", learning_rate=1e-4, frozen=True), 1, 2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is small: one intra-op thread is as
    fast, and keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturb_affine(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            if set(val) == {"scale", "bias"}:
                val["scale"] = rng.uniform(0.5, 1.5, val["scale"].shape).astype(np.float32)
                val["bias"] = (rng.standard_normal(val["bias"].shape) * 0.1).astype(np.float32)
            else:
                _perturb_affine(val, rng)


def _find(node, field):
    """The first ``field`` of a NamedTuple in a nested optax state."""
    if field in getattr(node, "_fields", ()):
        return getattr(node, field)
    if isinstance(node, (tuple, list)):
        for v in node:
            found = _find(v, field)
            if found is not None:
                return found
    return None


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    images = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    variables = JaxMNASNet(alpha=ALPHA, num_classes=CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), train=False)
    variables = jax.tree.map(np.array, variables)
    _perturb_affine(variables["params"], rng)
    # The init's classifier gain is set by fan_out; at 8 classes it makes
    # logits of ~15 and a loss that swings from step to step. Scaled down,
    # the steps stay in the smooth regime the comparison needs.
    variables["params"]["classifier"]["kernel"] *= 0.05
    return variables, images, labels


def _jax_opt_kwargs(opt):
    kw = {k: v for k, v in opt.items() if k != "frozen"}
    return kw


def _jax_run(step, tx, variables, images, labels, steps, small):
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState.create(params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                                 tx, jax.random.PRNGKey(0))
    losses = []
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels))
        losses.append(float(metrics["loss"]))
    out = {"losses": np.array(losses),
           "params": params_from_jax(jax.tree.map(np.asarray, state.params), ALPHA),
           "stats": stats_from_jax(jax.tree.map(np.asarray, state.batch_stats), ALPHA)}
    for field in ("ms", "mom", "trace"):
        tree = _find(state.opt_state, field)
        if tree is not None:
            if small:
                tree = unpack_flat(tree, state.params, small_only=True)
            out[field] = params_from_jax(jax.tree.map(np.asarray, tree), ALPHA)
    ema = jax_get_ema_params(state.opt_state)
    if ema is not None:
        out["ema"] = params_from_jax(jax.tree.map(np.asarray, ema), ALPHA)
    return out


@pytest.fixture(scope="module")
def jax_runs(case):
    """Per variant: the JAX step's losses and its final params, batch_stats,
    optimizer slots and EMA shadow, all by the port's names; and the same
    from a second run whose images moved by one ulp (the reference's own
    spread)."""
    variables, images, labels = case
    nudged = (images * (1 + 2.0 ** -23 * np.random.default_rng(12).choice(
        [-1.0, 1.0], images.shape))).astype(np.float32)
    out = {}
    for name, (model_kw, opt, accum, steps) in VARIANTS.items():
        model = JaxMNASNet(alpha=ALPHA, num_classes=CLASSES, dropout=0.0, dw_impl="xla",
                           precision="highest", bn_stats="two_pass", **model_kw)
        kw = _jax_opt_kwargs(opt)
        if opt.get("frozen"):
            kw["frozen_mask"] = jax_frozen_mask(variables["params"])
        tx = jax_create_optimizer(kw.pop("name"), kw.pop("learning_rate"), **kw)
        small = opt.get("fused") == "small"
        step = jax.jit(jax_make_train_step(model, tx, 0.1, grad_accum=accum))
        ref = _jax_run(step, tx, variables, images, labels, steps, small)
        moved = _jax_run(step, tx, variables, nudged, labels, steps, small)
        out[name] = (ref, moved)
    return out


def _port_run(case, name, route):
    variables, images, labels = case
    model_kw, opt, accum, steps = VARIANTS[name]
    model = create_model(f"mnasnet{str(ALPHA).replace('.', '_')}", device="cpu",
                         num_classes=CLASSES, dropout=0.0, bn_stats="two_pass",
                         dw_impl=route, bn_bwd=route, **model_kw)
    model.load_state_dict(state_dict_from_jax(variables, ALPHA), strict=True)
    kw = _jax_opt_kwargs(opt)
    if opt.get("frozen"):
        kw["frozen_mask"] = backbone_frozen_mask
    tx = create_optimizer(kw.pop("name"), kw.pop("learning_rate"), **kw)
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx, 0.1, grad_accum=accum)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, images, labels)
        losses.append(float(metrics["loss"]))
    assert state.step == steps and not model.training
    return model, tx, losses


def _close(ours, ref, moved, what):
    """|ours - ref| within the tolerance of tests/test_bn_bwd.py:115-130 plus
    SPREAD times the reference's own move under a one-ulp change of its
    input."""
    ours, ref, moved = np.asarray(ours), np.asarray(ref), np.asarray(moved)
    spread = float(np.abs(ref - moved).max())
    np.testing.assert_allclose(ours, ref, rtol=5e-3, atol=1e-4 + SPREAD * spread, err_msg=what)


def _core(tx):
    while hasattr(tx, "inner"):
        tx = tx.inner
    return tx


@pytest.mark.parametrize("route", ["kernel", "torch"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_step_matches_jax(case, jax_runs, name, route):
    ref, moved = jax_runs[name]
    model, tx, losses = _port_run(case, name, route)
    ours = {"losses": np.array(losses),
            "params": {n: p.detach().numpy() for n, p in model.named_parameters()},
            "stats": {n: b.numpy() for n, b in model.named_buffers()
                      if not n.endswith("num_batches_tracked")}}
    core = _core(tx)
    for field in ("ms", "mom", "trace"):
        if hasattr(core, field):
            ours[field] = {n: t.numpy() for n, t in getattr(core, field).items()}
    ema = get_ema_params(tx)
    if ema is not None:
        ours["ema"] = {n: t.numpy() for n, t in ema.items()}
    assert set(ours) == set(ref)
    assert set(ref) >= ({"trace"} if name == "sgd" else {"ms", "mom"})
    assert ("ema" in ref) == (name == "model_ema")
    _close(ours["losses"], ref["losses"], moved["losses"], "losses")
    for key in set(ref) - {"losses"}:
        assert set(ours[key]) == set(ref[key]), key
        for n in ref[key]:
            _close(ours[key][n], ref[key][n], moved[key][n], f"{key} {n}")
    if name == "freeze":
        initial = state_dict_from_jax(case[0], ALPHA)
        for n, p in ours["params"].items():
            if not n.startswith("classifier."):
                np.testing.assert_array_equal(p, initial[n].numpy(), err_msg=n)


def test_losses_fall_on_a_fixed_batch(jax_runs):
    losses = jax_runs["rmsprop_s2d"][0]["losses"]
    assert losses[-1] < losses[0]


def test_train_step_rejects():
    model = create_model("mnasnet0_35", device="cpu", num_classes=4)
    tx = create_optimizer("sgd", 0.1)
    with pytest.raises(ValueError, match="external"):
        make_train_step(model, tx, grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(model, tx, grad_accum=0)
    with pytest.raises(ValueError, match="unknown optimizer"):
        create_optimizer("adam", 0.1)
    ext = create_model("mnasnet0_35", device="cpu", num_classes=4, bn_ema="external")
    state = TrainState.create(ext, tx)
    step = make_train_step(ext, tx, grad_accum=3)
    with pytest.raises(ValueError, match="divisible"):
        step(state, np.zeros((4, 32, 32, 3), np.float32), np.zeros(4, np.int64))


def test_auto_grad_accum_matches_jax():
    assert [auto_grad_accum(b) for b in range(1, 700)] == \
        [jax_auto_grad_accum(b) for b in range(1, 700)]
    assert [auto_grad_accum(b) for b in (64, 128, 256, 384, 131)] == [1, 1, 2, 3, 1]


@pytest.mark.parametrize("name,kw,steps", [
    ("rmsprop", dict(fused="small"), 2),
    ("rmsprop", dict(fused=True, weight_decay=1e-2), 2),
    ("sgd", dict(), 2),
    ("rmsprop", dict(model_ema=0.9), 2),
    ("sgd", dict(frozen=True, model_ema=0.99, model_ema_warmup=False), 2),
    ("rmsprop", dict(frozen=True, weight_decay=1e-2), 2),
])
def test_optimizer_matches_optax_on_the_same_grads(name, kw, steps):
    """The same gradients into the JAX optimizer (optax, eager) and the
    port's, step after step: updates, parameters, slots and the EMA shadow
    agree to fp32 rounding. A warmup-cosine schedule checks the count."""
    model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES)
    sched = dict(name="cosine", base_lr=0.1, steps_per_epoch=2, epochs=3, warmup_epochs=0.5)
    kw = dict(kw)
    frozen = kw.pop("frozen", False)
    jparams = params_to_jax({n: p.detach().numpy() for n, p in model.named_parameters()}, ALPHA)
    jparams = jax.tree.map(jnp.asarray, jparams)
    jtx = jax_create_optimizer(name, jax_make_schedule(**sched), **kw,
                               **({"frozen_mask": jax_frozen_mask(jparams)} if frozen else {}))
    jstate = jtx.init(jparams)
    tx = create_optimizer(name, make_schedule(**sched), **kw,
                          **({"frozen_mask": backbone_frozen_mask} if frozen else {}))
    tx.init(model)
    params = dict(model.named_parameters())
    rng = np.random.default_rng(13)
    for _ in range(steps):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in params.items()}
        jup, jstate = jtx.update(jax.tree.map(jnp.asarray, params_to_jax(grads, ALPHA)), jstate,
                                 jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jup)
        up = tx.update({n: torch.from_numpy(g) for n, g in grads.items()})
        with torch.no_grad():
            for n, p in params.items():
                p.add_(up[n])
        ref = params_from_jax(jax.tree.map(np.asarray, jup), ALPHA)
        for n in params:
            # rsqrt may differ by an ulp between the two libraries.
            np.testing.assert_allclose(up[n].numpy(), ref[n], rtol=1e-5, atol=1e-7, err_msg=n)
    ref = params_from_jax(jax.tree.map(np.asarray, jparams), ALPHA)
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=1e-6, atol=1e-7, err_msg=n)
        if frozen and not n.startswith("classifier."):
            assert not np.any(np.asarray(up[n]))
    core = _core(tx)
    for field in ("ms", "mom", "trace"):
        tree = _find(jstate, field)
        if tree is None:
            assert not hasattr(core, field)
            continue
        if kw.get("fused"):
            tree = unpack_flat(tree, jparams, small_only=kw["fused"] == "small")
        ref = params_from_jax(jax.tree.map(np.asarray, tree), ALPHA)
        for n, t in getattr(core, field).items():
            np.testing.assert_allclose(t.numpy(), ref[n], rtol=1e-5, atol=1e-7, err_msg=field + n)
    ema = get_ema_params(tx)
    jema = jax_get_ema_params(jstate)
    assert (ema is None) == (jema is None)
    if ema is not None:
        ref = params_from_jax(jax.tree.map(np.asarray, jema), ALPHA)
        for n, t in ema.items():
            np.testing.assert_allclose(t.numpy(), ref[n], rtol=1e-6, atol=1e-7, err_msg=n)


def test_grad_accum_of_two_equal_halves_is_the_half_batch_step(case):
    """Two microbatches that hold the same images give each one the same
    statistics and gradients, weighted by 1/2: the accumulated step is then
    exactly the plain step on one half (BN statistics, EMA, loss, update)."""
    variables, images, labels = case
    half_x, half_y = images[:BATCH // 2], labels[:BATCH // 2]
    out = []
    for accum, x, y in ((2, np.concatenate([half_x, half_x]), np.concatenate([half_y, half_y])),
                        (1, half_x, half_y)):
        model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, dropout=0.0,
                             bn_ema="external")
        model.load_state_dict(state_dict_from_jax(variables, ALPHA))
        tx = create_optimizer("rmsprop", 1e-3)
        state = TrainState.create(model, tx)
        state, metrics = make_train_step(model, tx, 0.1, grad_accum=accum)(state, x, y)
        out.append((model.state_dict(), metrics))
    (sd_a, m_a), (sd_b, m_b) = out
    assert float(m_a["loss"]) == float(m_b["loss"])
    assert int(m_a["count"]) == 2 * int(m_b["count"]) and int(m_a["top1"]) == 2 * int(m_b["top1"])
    for k in sd_b:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd_a[k], sd_b[k]), k
