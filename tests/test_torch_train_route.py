"""The train route (``utils/routing.py:TrainRouted``, ``train/steps.py``), the
BN+ReLU backward ops and the optimizer's step scalars, on the CPU.

* ``opcheck`` of ``mnasnet_tpu_torch::bn_bwd_reduce``, ``::bn_bwd_dx`` and
  ``::dw_grad_weights``; the BN ops' CPU impls against the JAX
  ``_bn_bwd_pallas`` in Pallas interpret mode, at the tolerance of
  tests/test_torch_train_ops.py (fp32 rtol = atol = 2e-4, bf16 two ulps of
  the largest reference value).
* Three steps with a warmup-cosine learning rate that changes every step and
  a model EMA with warmup, through the device-side step scalars, against
  three jitted JAX ``make_train_step`` steps, at the tolerance of
  tests/test_torch_train.py (its one-ulp spread of the reference); and the
  step-scalar update bit for bit against the same formulas with the scalars
  as Python floats, on the same gradients.
* Route resolution; the graph route refused off the card and with replicas.
* The compile route for two steps against eager. One Inductor compile of
  the small train step takes minutes on this CPU, so the route runs with
  Dynamo's ``aot_eager`` backend (Dynamo with ``fullgraph=True`` and
  AOTAutograd, no code generation): the same ops in the same order, held
  bit for bit; Inductor's compile is held on the card
  (``tests/test_torch_gpu.py``, ``chip_smoke.py --only train``).
* The paths that change the model or the optimizer between steps write in
  place, so that a captured step stays valid across them.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.ops.pallas.bn_bwd import _bn_bwd_pallas
from mnasnet_tpu.train.optim import create_optimizer as jax_create_optimizer
from mnasnet_tpu.train.optim import get_ema_params as jax_get_ema_params
from mnasnet_tpu.train.schedules import make_schedule as jax_make_schedule
from mnasnet_tpu.train.state import TrainState as JaxTrainState
from mnasnet_tpu.train.steps import make_train_step as jax_make_train_step
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.convert.torch_converter import (
    params_from_jax,
    state_dict_from_jax,
    stats_from_jax,
)
from mnasnet_tpu_torch.data.dataset import SyntheticDataset
from mnasnet_tpu_torch.data.pipeline import DataLoader
from mnasnet_tpu_torch.data.transforms import train_transform
from mnasnet_tpu_torch.ops.cuda.bn_bwd import bn_bwd_dx, bn_bwd_reduce
from mnasnet_tpu_torch.ops.depthwise import dw_grad_weights
from mnasnet_tpu_torch.train.bn_recal import recalibrate_bn
from mnasnet_tpu_torch.train.checkpoint import CheckpointManager
from mnasnet_tpu_torch.train.optim import _lr_at, create_optimizer, get_ema_params
from mnasnet_tpu_torch.train.schedules import make_schedule
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_local_bn_train_step, make_train_step
from mnasnet_tpu_torch.train.trainer import swapped_params
from mnasnet_tpu_torch.utils import routing
from mnasnet_tpu_torch.utils.routing import TRAIN_ROUTE, TrainRouted, default_train_route

ALPHA, IMAGE, BATCH, CLASSES = 0.35, 32, 8, 8
ENV = "MNASNET_TPU_TORCH_ROUTE"
# tests/test_torch_train.py's multiple of the reference's one-ulp spread.
SPREAD = 25.0


@pytest.fixture(autouse=True)
def _no_route_override(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bn_case(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    mean = xt.float().mean(dim=(0, 1, 2))
    var = xt.float().var(dim=(0, 1, 2), unbiased=False)
    return xt, torch.from_numpy(dy).to(dtype), mean, var, torch.from_numpy(gamma), \
        torch.from_numpy(beta)


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_bn_bwd_reduce(dtype):
    x, dy, mean, var, gamma, beta = _bn_case((2, 5, 5, 6), dtype)
    inv = torch.rsqrt(var + 1e-5)
    torch.library.opcheck(torch.ops.mnasnet_tpu_torch.bn_bwd_reduce.default,
                          (x, dy, mean, inv, gamma, beta))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_bn_bwd_dx(dtype):
    x, dy, mean, var, gamma, beta = _bn_case((2, 5, 5, 6), dtype)
    inv = torch.rsqrt(var + 1e-5)
    dg, db = bn_bwd_reduce(x, dy, mean, inv, gamma, beta)
    for n in (50, 150):  # the local count, and a larger (sync-BN) one
        torch.library.opcheck(torch.ops.mnasnet_tpu_torch.bn_bwd_dx.default,
                              (x, dy, mean, inv, gamma, beta, dg, db, n))


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 2)])
def test_opcheck_dw_grad_weights(k, stride):
    g = torch.Generator().manual_seed(k)
    x = torch.randn(2, 9, 9, 8, generator=g)
    ho = (9 + 2 * (k // 2) - k) // stride + 1
    gy = torch.randn(2, ho, ho, 8, generator=g)
    torch.library.opcheck(torch.ops.mnasnet_tpu_torch.dw_grad_weights.default,
                          (x, gy, k, stride, k // 2))


def test_dw_grad_weights_turns_tf32_off_inside_the_op(monkeypatch):
    """The flag is off while the op's convolution runs and restored after:
    the op runs as it stands under a compiled backward, where a Python
    toggle around it would not be replayed."""
    seen = []
    conv = torch.nn.grad.conv2d_weight

    def recording(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv(*a, **kw)

    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x, gy = torch.randn(1, 6, 6, 4), torch.randn(1, 6, 6, 4)
    w = dw_grad_weights(x, gy, 3, 1, 1)
    assert seen == [False] and torch.backends.cudnn.allow_tf32
    assert w.shape == (3, 3, 1, 4) and w.dtype == torch.float32


def _pallas_close(out, ref, dtype):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(out - ref).max() <= 2 * 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 14, 14, 72)])
def test_bn_ops_cpu_impls_match_pallas(shape, dtype):
    x, dy, mean, var, gamma, beta = _bn_case(shape, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    jdy = jnp.asarray(dy.float().numpy()).astype(jdt)
    rdx, rdg, rdb = _bn_bwd_pallas(jx, jdy, jnp.asarray(mean.numpy()), jnp.asarray(var.numpy()),
                                   jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()), 1e-5)
    inv = torch.rsqrt(var + 1e-5)
    sums = torch.ops.mnasnet_tpu_torch.bn_bwd_reduce.default(x, dy, mean, inv, gamma, beta)
    assert sums.shape == (2, shape[-1]) and sums.dtype == torch.float32
    dx = torch.ops.mnasnet_tpu_torch.bn_bwd_dx.default(
        x, dy, mean, inv, gamma, beta, sums[0], sums[1], x.numel() // shape[-1])
    assert dx.dtype == dtype and dx.shape == x.shape
    _pallas_close(sums[0].numpy(), rdg, dtype)
    _pallas_close(sums[1].numpy(), rdb, dtype)
    _pallas_close(dx.float().numpy(), np.asarray(rdx, np.float32), dtype)
    # The wrappers are the ops.
    dg, db = bn_bwd_reduce(x, dy, mean, inv, gamma, beta)
    assert torch.equal(dg, sums[0]) and torch.equal(db, sums[1])
    assert torch.equal(bn_bwd_dx(x, dy, mean, inv, gamma, beta, dg, db), dx)


def test_bn_wrappers_refuse_autograd():
    x, dy, mean, var, gamma, beta = _bn_case((2, 4, 4, 6), torch.float32)
    inv = torch.rsqrt(var + 1e-5)
    with pytest.raises(RuntimeError, match="autograd"):
        bn_bwd_reduce(x.requires_grad_(), dy, mean, inv, gamma, beta)
    with torch.no_grad():
        dg, db = bn_bwd_reduce(x, dy, mean, inv, gamma, beta)
    with pytest.raises(ValueError, match="positive count"):
        bn_bwd_dx(x.detach(), dy, mean, inv, gamma, beta, dg, db, n=-1)


# ------------------------------------------------------- the step scalars


def _schedule(lib_make):
    # Warmup then cosine: a rate that changes at every one of the steps.
    return lib_make("cosine", 1e-4, 2, 3, warmup_epochs=1)


def test_schedule_changes_every_step():
    lrs = [_schedule(make_schedule)(i) for i in range(3)]
    assert len(set(lrs)) == 3


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    images = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    variables = JaxMNASNet(alpha=ALPHA, num_classes=CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), train=False)
    variables = jax.tree.map(np.array, variables)
    variables["params"]["classifier"]["kernel"] *= 0.05
    return variables, images, labels


def _jax_steps(variables, images, labels):
    model = JaxMNASNet(alpha=ALPHA, num_classes=CLASSES, dropout=0.0, dw_impl="xla",
                       precision="highest", bn_stats="two_pass", bn_ema="external",
                       stem_s2d=True)
    tx = jax_create_optimizer("rmsprop", _schedule(jax_make_schedule), fused="small",
                              model_ema=0.9)
    step = jax.jit(jax_make_train_step(model, tx, 0.1))
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                                 jax.tree.map(jnp.asarray, variables["batch_stats"]), tx,
                                 jax.random.PRNGKey(0))
    losses = []
    for _ in range(3):
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels))
        losses.append(float(metrics["loss"]))
    return {"losses": np.array(losses),
            "params": params_from_jax(jax.tree.map(np.asarray, state.params), ALPHA),
            "stats": stats_from_jax(jax.tree.map(np.asarray, state.batch_stats), ALPHA),
            "ema": params_from_jax(jax.tree.map(np.asarray,
                                                jax_get_ema_params(state.opt_state)), ALPHA)}


def _port_model(variables=None, **kw):
    model = create_model(f"mnasnet{str(ALPHA).replace('.', '_')}", device="cpu",
                         num_classes=CLASSES, bn_ema="external", stem_s2d=True,
                         **{"dropout": 0.0, "bn_stats": "two_pass", **kw})
    if variables is not None:
        model.load_state_dict(state_dict_from_jax(variables, ALPHA), strict=True)
    return model


def test_three_steps_with_a_changing_lr_and_model_ema_match_jax(case):
    variables, images, labels = case
    nudged = (images * (1 + 2.0 ** -23 * np.random.default_rng(22).choice(
        [-1.0, 1.0], images.shape))).astype(np.float32)
    ref, moved = _jax_steps(variables, images, labels), _jax_steps(variables, nudged, labels)
    model = _port_model(variables)
    tx = create_optimizer("rmsprop", _schedule(make_schedule), fused="small", model_ema=0.9)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, 0.1)
    assert step.route == "eager"
    losses, lrs, factors = [], [], []
    for _ in range(3):
        state, metrics = step(state, images, labels)
        losses.append(float(metrics["loss"]))
        lrs.append(float(tx.inner.lr))
        factors.append(float(tx.one_minus_d))
    assert lrs == [float(np.float32(_schedule(make_schedule)(i))) for i in range(3)]
    assert factors == [float(np.float32(1) - np.float32((1 + n) / np.float32(10 + n)))
                       for n in (np.float32(1), np.float32(2), np.float32(3))]
    ours = {"losses": np.array(losses),
            "params": {n: p.detach().numpy() for n, p in model.named_parameters()},
            "stats": {n: b.numpy() for n, b in model.named_buffers()
                      if not n.endswith("num_batches_tracked")},
            "ema": {n: t.numpy() for n, t in get_ema_params(tx).items()}}
    for key in ("losses", "params", "stats", "ema"):
        items = {"": (ours[key], ref[key], moved[key])} if key == "losses" else {
            n: (ours[key][n], ref[key][n], moved[key][n]) for n in ref[key]}
        assert key == "losses" or set(ours[key]) == set(ref[key])
        for n, (o, r, m) in items.items():
            spread = float(np.abs(np.asarray(r) - np.asarray(m)).max())
            np.testing.assert_allclose(o, r, rtol=5e-3, atol=1e-4 + SPREAD * spread,
                                       err_msg=f"{key} {n}")


def _float_update(tx, grads):
    """The update with its step scalars as Python floats: the formulas of
    ``train/optim.py`` as they were before the scalars moved to the device."""
    core = tx.inner if hasattr(tx, "inner") else tx
    lr = _lr_at(core.learning_rate, core.count)
    out = {}
    for names in core.groups:
        if names:
            out.update(zip(names, core._group_update(names, core._decayed_grads(grads, names),
                                                     lr)))
    core.count += 1
    if core is tx:
        return out
    tx.count += 1
    d = min(np.float32(tx.decay), (np.float32(1.0) + np.float32(tx.count))
            / (np.float32(10.0) + np.float32(tx.count)))
    one_minus_d = float(np.float32(1.0) - d)
    shadow = [tx.ema_params[n] for n in tx.names]
    new = torch._foreach_add([tx.params[n].detach() for n in tx.names],
                             [out[n] for n in tx.names])
    torch._foreach_sub_(shadow, torch._foreach_mul(torch._foreach_sub(shadow, new),
                                                   one_minus_d))
    return out


@pytest.mark.parametrize("name,kw", [
    ("rmsprop", dict(fused="small", model_ema=0.99)),
    ("rmsprop", dict(fused=True)),
    ("sgd", dict(fused=False, model_ema=0.9)),
    ("sgd", dict(fused="small")),
])
def test_step_scalars_are_bitwise_the_float_update(name, kw):
    models = [_port_model(seed=3) for _ in range(2)]
    txs = [create_optimizer(name, make_schedule("cosine", 0.05, 2, 3, warmup_epochs=1),
                            weight_decay=1e-3, **kw) for _ in range(2)]
    for m, tx in zip(models, txs):
        tx.init(m)
    g = torch.Generator().manual_seed(4)
    for _ in range(3):
        grads = {n: torch.randn(p.shape, generator=g) for n, p in models[0].named_parameters()}
        got = txs[0].update(grads)
        want = _float_update(txs[1], grads)
        assert all(torch.equal(got[n], want[n]) for n in want)
        for m, tx, u in zip(models, txs, (got, want)):
            with torch.no_grad():
                for n, p in m.named_parameters():
                    p.add_(u[n])
    a, b = txs[0].state_dict(), txs[1].state_dict()

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        return torch.equal(x, y) if torch.is_tensor(x) else x == y

    assert same(a, b)


# ------------------------------------------------------------- the route


def _setup(seed=0, dropout=0.2, model_ema=0.99, **model_kw):
    model = create_model(f"mnasnet{str(ALPHA).replace('.', '_')}", device="cpu",
                         num_classes=CLASSES, bn_ema="external", stem_s2d=True,
                         dw_impl="kernel", bn_bwd="kernel", dropout=dropout, seed=seed,
                         **model_kw)
    tx = create_optimizer("rmsprop", _schedule(make_schedule), fused="small",
                          model_ema=model_ema)
    return model, tx, TrainState.create(model, tx, seed=seed)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32),
            rng.integers(0, CLASSES, 4))


def test_default_train_route_is_eager_off_the_card():
    assert default_train_route("cpu") == "eager"
    assert default_train_route("cuda") == TRAIN_ROUTE
    assert TRAIN_ROUTE in routing.ROUTES
    model, tx, _ = _setup()
    assert make_train_step(model, tx).route == "eager"


@pytest.mark.parametrize("val,want", [("graph", "graph"), ("COMPILE", "compile"),
                                      ("eager", "eager"), ("none", "eager"), ("", "eager")])
def test_env_overrides_the_train_route(monkeypatch, val, want):
    monkeypatch.setenv(ENV, val)
    assert default_train_route("cpu") == want
    assert default_train_route("cuda") == want


def test_env_bad_train_route_raises(monkeypatch):
    monkeypatch.setenv(ENV, "jit")
    with pytest.raises(ValueError, match=ENV):
        default_train_route("cuda")


def test_graph_train_route_raises_on_the_cpu(monkeypatch):
    model, tx, _ = _setup()
    with pytest.raises(ValueError, match="CUDA device"):
        make_train_step(model, tx, route="graph")
    monkeypatch.setenv(ENV, "graph")
    with pytest.raises(ValueError, match="CUDA device"):
        make_train_step(model, tx)


def test_unknown_train_route_raises():
    model, tx, _ = _setup()
    with pytest.raises(ValueError, match="unknown route"):
        make_train_step(model, tx, route="jit")


@pytest.mark.parametrize("route", ["graph", "compile"])
def test_routes_other_than_eager_raise_with_replicas(monkeypatch, route):
    model, tx, _ = _setup()
    replicas = types.SimpleNamespace(world=2, rank=0)
    with pytest.raises(ValueError, match="replicas"):
        make_local_bn_train_step(model, tx, 0.1, replicas, route=route)
    monkeypatch.setenv(ENV, route)
    with pytest.raises(ValueError, match="replicas"):
        default_train_route("cuda", replicas)
    monkeypatch.delenv(ENV)
    assert default_train_route("cuda", replicas) == "eager"
    assert make_local_bn_train_step(model, tx, 0.1, replicas).route == "eager"


def test_eager_route_counts_calls_and_advances_the_host_state():
    model, tx, state = _setup()
    step = make_train_step(model, tx, 0.1)
    assert isinstance(step, TrainRouted) and not step.replays
    x, y = _batch()
    for i in range(2):
        state, metrics = step(state, x, y)
        assert state.step == tx.count == tx.inner.count == i + 1
    assert list(step.calls.values()) == [2]
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(model, tx, 0.1, grad_accum=3)(state, x, y)
    assert state.step == 2 and tx.count == 2  # a refused batch moves nothing


class _Recorder:
    """aot_autograd's forward and backward compilers that keep each graph
    and run it as it is (``aot_eager``)."""

    def __init__(self):
        from torch._dynamo.backends.common import aot_autograd
        from torch._functorch.aot_autograd import make_boxed_func

        self.fw, self.bw = [], []

        def keep(into):
            def compiler(gm, example_inputs):
                into.append(gm)
                return make_boxed_func(gm.forward)
            return compiler

        self.backend = aot_autograd(fw_compiler=keep(self.fw), bw_compiler=keep(self.bw))

    @staticmethod
    def ops(graphs):
        out = {}
        for gm in graphs:
            for node in gm.graph.nodes:
                t = str(node.target)
                if node.op == "call_function" and t.startswith("mnasnet_tpu_torch."):
                    out[t] = out.get(t, 0) + 1
        return out


@pytest.fixture(scope="module")
def compiled_runs():
    """Two steps on the compile route (``aot_eager``, recorded) and two on the
    eager route, from the same state, with dropout, a changing rate and the
    model EMA."""
    torch._dynamo.reset()
    x, y = _batch(1)
    out = {}
    rec = _Recorder()
    for route in ("eager", "compile"):
        model, tx, state = _setup(seed=5)
        kw = {"backend": rec.backend} if route == "compile" else {}
        step = make_train_step(model, tx, 0.1, route=route, **kw)
        losses = []
        for _ in range(2):
            state, metrics = step(state, x, y)
            losses.append(metrics["loss"])
        out[route] = {"losses": losses, "model": model.state_dict(),
                      "ema": {n: t.clone() for n, t in get_ema_params(tx).items()},
                      "generator": state.generator.get_state(), "step": step}
    yield out, rec
    torch._dynamo.reset()


def test_compile_route_equals_eager(compiled_runs):
    """Tolerance: bit for bit (``aot_eager`` runs the traced aten ops as
    eager runs them; Inductor's fused arithmetic is held on the card)."""
    out, _ = compiled_runs
    e, c = out["eager"], out["compile"]
    assert all(torch.equal(a, b) for a, b in zip(e["losses"], c["losses"]))
    for k in e["model"]:
        assert torch.equal(e["model"][k], c["model"][k]), k
    for k in e["ema"]:
        assert torch.equal(e["ema"][k], c["ema"][k]), k
    assert torch.equal(e["generator"], c["generator"])
    assert list(c["step"].calls.values()) == [2] and not c["step"].replays


def test_compile_route_holds_the_kernels_as_ops(compiled_runs):
    """One forward and one backward graph, no break (``fullgraph``): the
    forward holds the 17 dw ops, the backward 35 of each BN op and the 17
    dw weight-gradient ops."""
    _, rec = compiled_runs
    assert len(rec.fw) == 1 and len(rec.bw) == 1
    assert _Recorder.ops(rec.fw) == {"mnasnet_tpu_torch.dw_conv_bn_act.default": 17}
    assert _Recorder.ops(rec.bw) == {"mnasnet_tpu_torch.bn_bwd_reduce.default": 35,
                                     "mnasnet_tpu_torch.bn_bwd_dx.default": 35,
                                     "mnasnet_tpu_torch.dw_grad_weights.default": 17}


# ------------------------------------------------ in-place state changes


def _addresses(model, tx, state):
    core = tx.inner
    tensors = {**{f"p.{n}": p for n, p in model.named_parameters()},
               **{f"b.{n}": b for n, b in model.named_buffers()},
               **{f"ms.{n}": t for n, t in core.ms.items()},
               **{f"mom.{n}": t for n, t in core.mom.items()},
               **{f"ema.{n}": t for n, t in tx.ema_params.items()},
               "lr": core.lr, "one_minus_d": tx.one_minus_d}
    return {k: t.data_ptr() for k, t in tensors.items()}, id(state.generator)


def test_state_changes_between_steps_write_in_place(tmp_path):
    """A captured step reads every tensor at the address it had at the
    capture: the model-EMA swap, BN recalibration, a checkpoint restore and
    the step itself keep every address, and the generator object."""
    model, tx, state = _setup(seed=6)
    step = make_train_step(model, tx, 0.1)
    x, y = _batch(2)
    state, _ = step(state, x, y)
    before = _addresses(model, tx, state)
    with swapped_params(model, get_ema_params(tx)):
        pass
    loader = DataLoader(SyntheticDataset(8, IMAGE, CLASSES, seed=0), 4,
                        lambda img, rng: train_transform(img, IMAGE, rng), shuffle=True,
                        drop_last=True, workers=0)
    recalibrate_bn(model, loader, num_batches=1, verbose=False)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, model, tx, state, 0.0, 0.0, wait=True)
    state, _ = step(state, x, y)
    mgr.restore(model, tx, state)
    assert state.step == 1 and tx.count == 1
    state, _ = step(state, x, y)
    assert _addresses(model, tx, state) == before
