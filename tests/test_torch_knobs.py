"""The port's model knobs against the JAX package: the depthwise routes
``taps``, ``taps2`` and ``hybrid`` (``mnasnet_tpu/ops/depthwise.py``),
``pw_lowering``, ``channel_pad`` and ``remat`` (``mnasnet_tpu/models/``).

Inputs are made with numpy from a seed; weights go from a seeded JAX
``MNASNet.init`` (BN affine perturbed, classifier scaled down) into the port
through ``state_dict_from_jax``. fp32 with TF32 off on the torch side and
``precision="highest"`` on the JAX side unless a test says bf16; alpha 0.35,
32-64 px. Each test states its tolerance:

  * ops in fp32: 1e-5 of the reference's largest magnitude (the same fp32
    arithmetic summed in another order);
  * whole-model eval forwards in fp32: 1e-4 of the largest logit (17
    layers of such sums);
  * whole-model train forwards (logits, BN statistics) and gradients: the
    bars of tests/test_torch_train.py (rtol 5e-3, atol 1e-4 plus ``SPREAD``
    times the reference's own move when its images change by one ulp): with
    batch statistics at random init a 1e-6 rounding difference flips ReLU
    masks and moves the logits of this small batch by 2e-4 and single
    BN-scale gradients by percents;
  * ``remat`` and the routes the port holds against its own other routes:
    bit for bit, where the two compute the same ops on the same inputs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.ops.depthwise import _dw_conv_hybrid, _hybrid_wins, _taps_depthwise
from mnasnet_tpu.train.loss import cross_entropy as jax_cross_entropy
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.convert.torch_converter import (
    params_from_jax,
    state_dict_from_jax,
    stats_from_jax,
)
from mnasnet_tpu_torch.models.layers import PW_AUTO, PointwiseConv
from mnasnet_tpu_torch.models.mnasnet import InvertedResidual
from mnasnet_tpu_torch.ops.depthwise import _torch_depthwise, depthwise_conv2d, hybrid_wins
from mnasnet_tpu_torch.pretrained import load_weights
from mnasnet_tpu_torch.train.checkpoint import CheckpointManager
from mnasnet_tpu_torch.train.loss import cross_entropy
from mnasnet_tpu_torch.train.optim import backbone_frozen_mask, create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_train_step

ALPHA, CLASSES = 0.35, 8
SPREAD = 25.0  # tests/test_torch_train.py's multiple of the one-ulp spread
# (images, px) of the gradient comparisons: the head BN then normalises 32
# rows, not the 4 of 4 images at 32 px, where a flipped ReLU mask moves a
# BN bias gradient by 20%.
GRAD_BATCH = (8, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads, tf32 = torch.get_num_threads(), torch.backends.cudnn.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32 = tf32


def _close(ours, ref, tol, what=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, what
    err = float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------ depthwise routes


def _dw_case(h, c, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, h, c)).astype(np.float32)
    kern = (rng.standard_normal((k, k, 1, c)) * 0.3).astype(np.float32)
    head = rng.standard_normal(c).astype(np.float32)
    return x, kern, head


def _port_grads(fn, x, kern, head, dtype=torch.float32):
    """y = fn(x, kernel) and the gradients of Σ sin(y)·head (a nonlinear head,
    so that dx is not trivial)."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    kt = torch.from_numpy(kern).requires_grad_(True)
    y = fn(xt, kt)
    (torch.sin(y.float()) * torch.from_numpy(head)).sum().backward()
    return y, xt.grad, kt.grad


def _jax_grads(fn, x, kern, head):
    def loss(x, w):
        return jnp.sum(jnp.sin(fn(x, w).astype(jnp.float32)) * head)

    y = fn(jnp.asarray(x), jnp.asarray(kern))
    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kern))
    return np.asarray(y), np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_taps_matches_jax_taps(k, stride):
    """``taps`` forward, dx and dw against ``_taps_depthwise`` and its
    ``jax.grad`` at an odd size (15x15). Tolerance 1e-5 of the largest
    magnitude: the same fp32 taps in the same order; autograd's and JAX's
    transposes sum the gradients in other orders."""
    x, kern, head = _dw_case(15, 16, k)
    y, gx, gw = _port_grads(lambda a, w: depthwise_conv2d(a, w, stride=stride, impl="taps"),
                            x, kern, head)
    ry, rgx, rgw = _jax_grads(lambda a, w: _taps_depthwise(a, w, stride, k // 2), x, kern, head)
    for ours, ref, what in ((y, ry, "y"), (gx, rgx, "dx"), (gw, rgw, "dw")):
        _close(_np(ours), ref, 1e-5, what)


def test_taps_bf16_in_and_out_with_fp32_accumulation():
    """bf16 in and out, fp32 weight and accumulator (``tests/test_dw_taps.py
    :68-77``): the port's and JAX's taps round the same fp32 sum once, so
    they agree within one bf16 ulp of the largest output (2^-7)."""
    x, kern, _ = _dw_case(16, 32, 5, seed=1)
    ours = depthwise_conv2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(kern),
                            stride=1, impl="taps")
    ref = _taps_depthwise(jnp.asarray(x, jnp.bfloat16), jnp.asarray(kern), 1, 2)
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(_np(ours), np.asarray(ref, np.float32), 2.0 ** -7, "bf16 taps")


@pytest.mark.parametrize("stride", [1, 2])
def test_taps2_is_taps_at_stride_2_and_torch_elsewhere(stride):
    """Bit for bit, forward and gradients: ``taps2`` runs the same ops as
    ``taps`` at stride 2 and as ``torch`` at stride 1."""
    x, kern, head = _dw_case(14, 16, 3, seed=2)
    same_as = "taps" if stride == 2 else "torch"
    got = _port_grads(lambda a, w: depthwise_conv2d(a, w, stride=stride, impl="taps2"),
                      x, kern, head)
    want = _port_grads(lambda a, w: depthwise_conv2d(a, w, stride=stride, impl=same_as),
                       x, kern, head)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [3, 5])
def test_hybrid_matches_jax_hybrid_where_it_wins(k):
    """``hybrid`` at a shape where ``_hybrid_wins`` holds (stride 2, H = 28)
    against ``_dw_conv_hybrid``: the forward and (dx, dw), within 1e-5 of
    the largest magnitude."""
    assert _hybrid_wins(28, k, 2) and hybrid_wins(28, k, 2)
    x, kern, head = _dw_case(28, 16, k, seed=3)
    y, gx, gw = _port_grads(lambda a, w: depthwise_conv2d(a, w, stride=2, impl="hybrid"),
                            x, kern, head)
    ry, rgx, rgw = _jax_grads(lambda a, w: _dw_conv_hybrid(a, w, 2, k // 2), x, kern, head)
    for ours, ref, what in ((y, ry, "y"), (gx, rgx, "dx"), (gw, rgw, "dw")):
        _close(_np(ours), ref, 1e-5, what)
    assert y.grad_fn.name().endswith("_HybridDepthwiseBackward")


@pytest.mark.parametrize("h,stride", [(28, 1), (14, 2)])
def test_hybrid_takes_the_torch_route_elsewhere(h, stride):
    """Where ``_hybrid_wins`` does not hold, ``hybrid`` is the torch route,
    bit for bit (forward and gradients)."""
    assert not hybrid_wins(h, 3, stride) and not _hybrid_wins(h, 3, stride)
    x, kern, head = _dw_case(h, 16, 3, seed=4)
    got = _port_grads(lambda a, w: depthwise_conv2d(a, w, stride=stride, impl="hybrid"),
                      x, kern, head)
    want = _port_grads(lambda a, w: _torch_depthwise(a, w, stride, 1), x, kern, head)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------ JAX weights


def _perturb_affine(tree, rng):
    for val in tree.values():
        if isinstance(val, dict):
            if set(val) == {"scale", "bias"}:
                val["scale"] = rng.uniform(0.5, 1.5, val["scale"].shape).astype(np.float32)
                val["bias"] = (rng.standard_normal(val["bias"].shape) * 0.1).astype(np.float32)
            else:
                _perturb_affine(val, rng)


_VARIABLES = {}


def _variables(channel_pad=1, image=32):
    """Seeded JAX variables (numpy) of mnasnet0_35 with ``channel_pad``."""
    key = (channel_pad, image)
    if key not in _VARIABLES:
        rng = np.random.default_rng(11)
        v = JaxMNASNet(alpha=ALPHA, num_classes=CLASSES, channel_pad=channel_pad).init(
            jax.random.PRNGKey(0), jnp.zeros((1, image, image, 3)), train=False)
        v = jax.tree.map(np.array, v)
        _perturb_affine(v["params"], rng)
        v["params"]["classifier"]["kernel"] *= 0.05
        _VARIABLES[key] = v
    return _VARIABLES[key]


def _images(n=4, image=32, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, image, image, 3)).astype(np.float32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _nudged(images):
    return (images * (1 + 2.0 ** -23 * np.random.default_rng(12).choice(
        [-1.0, 1.0], images.shape))).astype(np.float32)


def _jax_model(**kw):
    return JaxMNASNet(alpha=ALPHA, num_classes=CLASSES, dropout=0.0, precision="highest",
                      bn_stats="two_pass", **kw)


def _port_model(variables, **kw):
    model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, dropout=0.0,
                         bn_stats="two_pass", **kw)
    model.load_state_dict(state_dict_from_jax(variables, ALPHA), strict=True)
    return model


def _jax_train(model, variables, images, labels, grads=True):
    """The JAX train forward: logits, the updated batch_stats and (with
    ``grads``) the gradients of the label-smoothed loss, by the port's
    names; jitted."""
    def loss(params):
        logits, new = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(images), train=True, mutable=["batch_stats"])
        return jax_cross_entropy(logits, jnp.asarray(labels), 0.1), (logits, new)

    params = jax.tree.map(jnp.asarray, variables["params"])
    if grads:
        g, (logits, new) = jax.jit(jax.grad(loss, has_aux=True))(params)
    else:
        g, (logits, new) = None, jax.jit(loss)(params)[1]
    out = {"logits": np.asarray(logits),
           "stats": stats_from_jax(jax.tree.map(np.asarray, new["batch_stats"]), ALPHA)}
    if grads:
        out["grads"] = params_from_jax(jax.tree.map(np.asarray, g), ALPHA)
    return out


def _jax_eval(model, variables, images):
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images)))


def _port_train(model, images, labels):
    model.train()
    logits = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    loss = cross_entropy(logits, torch.from_numpy(labels).long(), 0.1)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    model.eval()
    return {"logits": _np(logits),
            "stats": {n: _np(b) for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "grads": dict(zip(names, (_np(g) for g in grads)))}


def _port_eval(model, images):
    with torch.no_grad():
        return _np(model(torch.from_numpy(images).permute(0, 3, 1, 2)))


def _flat(run):
    """A train run's logits, statistics and gradients as one dict."""
    return {"logits": run["logits"], **{f"stats {n}": t for n, t in run["stats"].items()},
            **{f"grad {n}": t for n, t in run.get("grads", {}).items()}}


def _assert_within_spread(ours, ref, moved, what, ours_moved=None):
    """tests/test_torch_train.py's bars: rtol 5e-3, atol 1e-4 plus SPREAD
    times the reference's own move when its images change by one ulp (or the
    port's own move, ``ours_moved``, where that is larger), for the logits,
    BN statistics and gradients of a train-mode forward (those ``ref``
    holds)."""
    ours, ref, moved = _flat(ours), _flat(ref), _flat(moved)
    own = _flat(ours_moved) if ours_moved is not None else None
    assert set(ref) <= set(ours)
    for n in ref:
        spread = float(np.abs(ref[n] - moved[n]).max())
        if own is not None:
            spread = max(spread, float(np.abs(ours[n] - own[n]).max()))
        np.testing.assert_allclose(ours[n], ref[n], rtol=5e-3, atol=1e-4 + SPREAD * spread,
                                   err_msg=f"{what} {n}")


def _against_jax(jm, pm, variables, images, labels, grads, what):
    """The port's train forward (and gradients) against the JAX model's,
    within the spread bars of both packages' own one-ulp moves (at a point
    where a one-ulp change flips a ReLU mask in one package and not in the
    other, each package's difference from the other is its own move); the
    eval logits within 1e-4 of the largest."""
    _close(_port_eval(pm, images), _jax_eval(jm, variables, images), 1e-4, f"{what} eval")
    sd = {k: t.clone() for k, t in pm.state_dict().items()}
    ref = _jax_train(jm, variables, images, labels, grads)
    moved = _jax_train(jm, variables, _nudged(images), labels, grads)
    ours = _port_train(pm, images, labels)
    pm.load_state_dict(sd)
    _assert_within_spread(ours, ref, moved, what, _port_train(pm, _nudged(images), labels))


@pytest.mark.parametrize("impl,image", [("taps", 32), ("taps2", 32), ("hybrid", 64)])
def test_model_train_forward_on_each_route_matches_jax(impl, image):
    """The whole train-mode forward with each route against the JAX model
    with the same ``dw_impl``: logits and module-EMA BN statistics within
    the spread bars (``hybrid`` at 64 px, where a stride-2 layer has 32 rows
    and takes its own backward), and the eval logits."""
    v = _variables(image=image)
    images, labels = _images(image=image)
    _against_jax(_jax_model(dw_impl=impl, bn_momentum=0.5),
                 _port_model(v, dw_impl=impl, bn_momentum=0.5), v, images, labels, False, impl)


def test_training_routes_serve_on_the_torch_route_with_the_folded_affine():
    """In eval mode ``taps``, ``taps2`` and ``hybrid`` run the torch route and
    the folded BN affine, as the reference's ``depthwise_conv_bn_relu_fused``
    does: the eval logits of the ``torch`` route, bit for bit."""
    v = _variables()
    x = torch.from_numpy(_images()[0]).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = _port_model(v, dw_impl="torch")(x)
        for impl in ("taps", "taps2", "hybrid"):
            assert torch.equal(_port_model(v, dw_impl=impl)(x), want), impl


# ------------------------------------------------------------ pw_lowering


def test_pw_lowering_conv_and_dot_agree_and_auto_is_its_mapping():
    """``conv`` ≈ ``dot`` on the same parameters: in eval mode within 1e-5 of
    the largest logit (the same products summed in another order), in train
    mode within the spread bars of ``dot``'s own one-ulp move; ``auto`` bit
    for bit the lowering ``PW_AUTO`` gives each mode, BN statistics
    included; one state_dict loads under every lowering."""
    v = _variables()
    images, labels = _images()
    models = {lw: _port_model(v, pw_lowering=lw) for lw in ("conv", "dot", "auto")}
    sd = models["dot"].state_dict()
    for m in models.values():
        m.load_state_dict(sd, strict=True)
    ev = {lw: _port_eval(m, images) for lw, m in models.items()}
    _close(ev["conv"], ev["dot"], 1e-5, "eval conv vs dot")
    assert np.array_equal(ev["auto"], ev[PW_AUTO["eval"]])
    tr = {lw: _port_train(m, images, labels) for lw, m in models.items()}
    moved = _port_train(_port_model(v, pw_lowering="dot"), _nudged(images), labels)
    _assert_within_spread(tr["conv"], tr["dot"], moved, "train conv vs dot")
    _assert_same(_flat(tr["auto"]), _flat(tr[PW_AUTO["train"]]))
    lowered = [m for m in models["auto"].modules()
               if isinstance(m, PointwiseConv) and m.lowering == "auto"]
    assert len(lowered) == 32  # the 16 blocks' expand and project convs only


@pytest.mark.parametrize("lowering", ["conv", "dot"])
def test_pw_lowering_matches_jax_with_the_same_lowering(lowering):
    """The eval logits (1e-4 of the largest) and the train-mode logits and
    BN statistics (spread bars) against the JAX model with the same
    ``pw_lowering``."""
    v = _variables()
    images, labels = _images()
    _against_jax(_jax_model(pw_lowering=lowering, bn_momentum=0.5),
                 _port_model(v, pw_lowering=lowering, bn_momentum=0.5), v, images, labels,
                 False, lowering)


# ------------------------------------------------------------ channel_pad


@pytest.mark.parametrize("pad", [8, 16])
def test_channel_pad_matches_jax(pad):
    """A padded model against the JAX model with the same ``channel_pad``:
    its padded parameters carry over (``state_dict_from_jax``); the eval
    logits within 1e-4 of the largest, the train-mode logits, BN statistics
    and gradients within tests/test_torch_train.py's bars."""
    v = _variables(pad)
    images, labels = _images(*GRAD_BATCH)
    pm = _port_model(v, channel_pad=pad, bn_momentum=0.5)
    if pad == 16:  # alpha 0.35's widths 8 and 56 pad to 16 and 64
        assert pm.layers[6].weight.shape[0] == 16 and pm.layers[13][0].in_ch == 64
    _against_jax(_jax_model(channel_pad=pad, bn_momentum=0.5), pm, v, images, labels, True,
                 f"channel_pad {pad}")


def test_channel_pad_checkpoints(tmp_path):
    """A padded model's own checkpoint resumes bit for bit; an unpadded
    (torchvision-width) state_dict is refused with a message naming
    ``channel_pad``, and so is a padded one by an unpadded model; a pad whose
    widths the dw kernel cannot take raises on the kernel route."""
    model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, channel_pad=16,
                         bn_ema="external")
    tx = create_optimizer("rmsprop", 1e-3, fused="small")
    state = TrainState.create(model, tx)
    images, labels = _images()
    state, _ = make_train_step(model, tx, 0.1)(state, images, labels)
    CheckpointManager(str(tmp_path)).save(0, model, tx, state, acc1=0.0, best_acc1=0.0)
    fresh = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, channel_pad=16,
                         bn_ema="external", seed=1)
    ftx = create_optimizer("rmsprop", 1e-3, fused="small")
    fstate = TrainState.create(fresh, ftx)
    CheckpointManager(str(tmp_path)).restore(fresh, ftx, fstate)
    for k, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    assert fstate.step == state.step
    load_weights(fresh, model.state_dict())
    plain = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES)
    with pytest.raises(ValueError, match="channel_pad=16"):
        load_weights(fresh, plain.state_dict())
    with pytest.raises(ValueError, match="channel_pad"):
        load_weights(plain, model.state_dict())
    # 12 pads the separable width 16 to 24 and 56 to 60: not a multiple of 8.
    for knob in ("dw_impl", "bn_bwd"):
        with pytest.raises(ValueError, match="channel_pad=12"):
            create_model("mnasnet0_35", device="cpu", channel_pad=12, **{knob: "kernel"})
    torch_route = create_model("mnasnet0_35", device="cpu", channel_pad=12, dw_impl="torch",
                               bn_bwd="torch")
    assert torch_route(torch.zeros(1, 3, 32, 32)).shape == (1, 1000)


def test_channel_pad_mid_width_and_the_fused_block_plan():
    """The expanded width rounds up as the reference's ``mid_pad`` does, and
    the fused block's planner sees that width; a block without a plan keeps
    the unfused kernel route (tests/test_torch_model.py)."""
    block = InvertedResidual(24, 24, 3, 1, 3, dw_impl="kernel", mid_pad=64)
    assert block.mid_ch == 128 and block.layers[3].weight.shape[0] == 128
    assert block.eval()._use_fused_block(torch.zeros(1, 24, 8, 8), "kernel")
    model = create_model("mnasnet0_35", device="cpu", channel_pad=64)
    assert {m.mid_ch % 64 for m in model.modules() if isinstance(m, InvertedResidual)} == {0}


# ------------------------------------------------------------ remat


def _step_run(remat, dtype=torch.float32, ema="external", grad_accum=1, frozen=False,
              dropout=0.0, steps=2):
    """``steps`` steps of mnasnet0_35 at 32 px (kernel route: the plain
    versions) from one init; everything a bitwise comparison reads."""
    model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES, dtype=dtype,
                         bn_ema=ema, stem_s2d=True, dw_impl="kernel", bn_bwd="kernel",
                         dropout=dropout, remat=remat, seed=3)
    tx = create_optimizer("rmsprop", 1e-3, fused="small",
                          frozen_mask=backbone_frozen_mask if frozen else None)
    state = TrainState.create(model, tx, seed=4)
    step = make_train_step(model, tx, 0.1, grad_accum=grad_accum, diagnostics=True)
    images, labels = _images()
    metrics = []
    for _ in range(steps):
        state, m = step(state, images, labels)
        metrics.append({k: t.clone() for k, t in m.items()})
    return {"metrics": metrics, "model": {k: t.clone() for k, t in model.state_dict().items()},
            "tx": tx.state_dict(), "generator": state.generator.get_state()}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kw", [
    dict(ema="module"),
    dict(ema="external"),
    dict(ema="external", dtype=torch.bfloat16),
    dict(ema="module", dtype=torch.bfloat16),
    dict(ema="external", grad_accum=2),
    dict(ema="external", frozen=True),
    dict(ema="external", dropout=0.2),
], ids=["module", "external", "external-bf16", "module-bf16", "accum2", "frozen", "dropout"])
def test_remat_step_is_the_step_bit_for_bit(kw):
    """Two steps with and without ``remat``: the loss, the metrics (the
    gradient norm among them), every parameter, ``running_mean``/
    ``running_var`` and ``num_batches_tracked`` (each BN updates once a
    forward), the optimizer state and the dropout generator, bit for bit."""
    _assert_same(_step_run(True, **kw), _step_run(False, **kw))


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    """Each block's body runs twice a train step under ``remat`` (the
    forward and the backward's recompute), once without; the gradients are
    the same bit for bit, and eval mode never checkpoints."""
    calls = []
    orig = InvertedResidual._train_body

    def counted(self, *a):
        calls.append(self)
        return orig(self, *a)

    monkeypatch.setattr(InvertedResidual, "_train_body", counted)
    v = _variables()
    images, labels = _images()
    grads = {}
    for remat in (False, True):
        del calls[:]
        grads[remat] = _port_train(_port_model(v, remat=remat), images, labels)["grads"]
        assert len(calls) == 16 * (2 if remat else 1)
    for n in grads[False]:
        assert np.array_equal(grads[True][n], grads[False][n]), n
    model = _port_model(v, remat=True)
    del calls[:]
    model(torch.zeros(1, 3, 32, 32))
    assert not calls


def test_remat_gradients_match_the_jax_remat_model():
    """The port's ``remat`` gradients, logits and BN statistics against
    the JAX model built with ``remat=True`` (``nn.remat``), within the bars
    of tests/test_torch_train.py."""
    v = _variables()
    images, labels = _images(*GRAD_BATCH)
    _against_jax(_jax_model(remat=True), _port_model(v, remat=True), v, images, labels, True,
                 "remat")


def _compiled_backend(graphs):
    from torch._dynamo.backends.common import aot_autograd
    from torch._functorch.aot_autograd import make_boxed_func

    def keep(kind):
        def compiler(gm, example_inputs):
            graphs.append((kind, gm))
            return make_boxed_func(gm.forward)
        return compiler

    return aot_autograd(fw_compiler=keep("fw"), bw_compiler=keep("bw"))


def test_remat_on_the_compile_route():
    """The compile route with ``remat`` (``fullgraph=True``: no graph break;
    ``aot_eager``, which runs the traced ops as eager runs them, as
    tests/test_torch_train_route.py holds the route; Inductor's fused
    arithmetic is held on the card): two steps bit for bit the eager
    ``remat`` step, and the backward graph recomputes the 16 blocks' dw
    ops."""
    torch._dynamo.reset()
    graphs = []
    try:
        runs = {}
        for route in ("eager", "compile"):
            model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES,
                                 bn_ema="external", stem_s2d=True, dw_impl="kernel",
                                 bn_bwd="kernel", remat=True, seed=3)
            tx = create_optimizer("rmsprop", 1e-3, fused="small")
            state = TrainState.create(model, tx, seed=4)
            kw = {"backend": _compiled_backend(graphs)} if route == "compile" else {}
            step = make_train_step(model, tx, 0.1, route=route, **kw)
            images, labels = _images()
            losses = []
            for _ in range(2):
                state, m = step(state, images, labels)
                losses.append(m["loss"])
            runs[route] = (losses, model.state_dict())
    finally:
        torch._dynamo.reset()
    _assert_same(runs["compile"], runs["eager"])
    kinds = [k for k, _ in graphs]
    assert kinds == ["fw", "bw"]

    def dw_ops(gm):
        return sum(1 for n in gm.graph.nodes if n.op == "call_function"
                   and str(n.target) == "mnasnet_tpu_torch.dw_conv_bn_act.default")

    assert dw_ops(graphs[0][1]) == 17 and dw_ops(graphs[1][1]) == 16


def test_remat_leaves_the_state_dict_as_it_is():
    """``remat`` changes no parameter or buffer: a remat model's state_dict
    loads into a plain one and back, strictly."""
    a = create_model("mnasnet0_35", device="cpu", remat=True)
    b = create_model("mnasnet0_35", device="cpu", seed=1)
    b.load_state_dict(a.state_dict(), strict=True)
    a.load_state_dict(b.state_dict(), strict=True)
