"""The port's ``data × spatial`` mesh on the CPU: the band plan and the halo
exchange, the kernels' plain versions on bands, and the sync-BN step, the
eval forward, validation, recal and the ``dcn`` mesh over spawned gloo
ranks, against one process and against the reference's ``Trainer`` on
``make_mesh(devices[:2], data=1, spatial=2)``.

The exchange and the kernels on bands run here in one process, the ranks of
a spatial group as threads whose all-reduce is a sum across them
(``_Group``): the real ``parallel/spatial.py`` code on every band plan,
including planes shorter than the halo and empty bands. The mesh runs
spawn gloo ranks (``tests/torch_spatial_worker.py``, no JAX) at world 2 (a
1x2 mesh, and the ``dcn=2`` and flat meshes) and world 4 (a 2x2 mesh)
once for the module, while this process runs the one-process references
and the reference's meshes.

Tolerances, each with its reason:
  * the exchange: the window's rows exactly; the adjoint identity
    <E x, g> = <x, Eᵀ g> summed over the ranks to 1e-12 relative (float64
    sums of the same products in another order);
  * a kernel's plain version on bands against the whole plane, fp32:
    values 1e-6 and gradients 1e-5 of the largest magnitude (the same fp32
    products; the weight gradient's and the halo rows' sums in another
    order);
  * the float64 runs (torch routes, model in float64; the gradients and
    the validation sums are summed over the ranks in float64) against one
    process: 1e-9 relative RMS of each update, each state tensor and the
    logits (measured: ~2e-14, a reordered float64 sum amplified by the
    batch-statistic backward); top-k exactly; the loss to 2^-22 relative,
    as it is fp32 by design (``MNASNet.classify`` returns fp32 logits, and
    the shards' weighted losses add in fp32 in another grouping);
  * the ``dcn=2`` mesh against the flat data mesh: bit for bit, as the
    reference's ``tests/test_parallel.py:303-328`` holds its meshes;
  * fp32 against the reference's ``Trainer`` on its 1x2 mesh: the forward
    (logits before the step, the step's loss and its BN moments) within
    4 times the reference's own spread between its one-device and its 1x2
    meshes, or 1e-5 relative (logits: 1e-5 of the largest), whichever is
    larger; the step's update within 4 times the reference's one-device
    vs ``data=2`` spread at this setting, taken here (measured: 1.56e-2,
    against 1.35e-3 for the port), as an fp32 step at random init is
    ill-conditioned.
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_spatial_worker as W
from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.parallel.mesh import batch_sharding, replicate_state, replicated
from mnasnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mnasnet_tpu.train.optim import create_optimizer as jax_create_optimizer
from mnasnet_tpu.train.state import TrainState as JaxTrainState
from mnasnet_tpu.train.trainer import Trainer as JaxTrainer
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.convert.torch_converter import (
    params_from_jax,
    state_dict_from_jax,
    stats_from_jax,
)
from mnasnet_tpu_torch.models.layers import StemConv, nchw, nhwc
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fused
from mnasnet_tpu_torch.ops.depthwise import depthwise_conv2d, depthwise_conv_bn_relu_fused
from mnasnet_tpu_torch.parallel import Replicas, make_mesh, shard_batch, take_band
from mnasnet_tpu_torch.parallel import mesh as M
from mnasnet_tpu_torch.parallel import spatial as S
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.steps import make_local_bn_train_step

SPAWN_TIMEOUT_S = 240
SPREAD = 4.0  # chip_smoke.py's multiple of a reference's own move
F64_BAR = 1e-9

# (plane rows, ranks of a spatial group, k, stride): even, uneven, 1-row
# bands under a k=5 halo, empty bands, both strides.
CASES = [(16, 2, 3, 1), (7, 2, 3, 1), (7, 2, 5, 2), (14, 2, 3, 2), (2, 2, 5, 1), (4, 2, 5, 2),
         (1, 2, 3, 1), (3, 4, 5, 1), (5, 4, 3, 2), (14, 4, 5, 1), (2, 4, 3, 2)]


# ---------------------------------------------------------------- threads
class _Group:
    """The ranks of one spatial group as threads: each calls ``run(i)``,
    and the exchange's all-reduce sums the ranks' integer words."""

    def __init__(self, parts: int):
        self.parts = parts
        self.barrier = threading.Barrier(parts, timeout=60)
        self.words = [None] * parts
        self.calls = 0

    def sum_(self, buf, replicas, what):
        words = S._words(buf)
        self.words[replicas.rank] = words.clone()
        self.barrier.wait()
        total = torch.stack(self.words).sum(0, dtype=words.dtype)
        self.barrier.wait()
        words.copy_(total)
        if replicas.rank == 0:
            self.calls += 1

    def run(self, fn):
        out, errors = [None] * self.parts, []

        def target(i):
            try:
                out[i] = fn(i, types.SimpleNamespace(rank=i, mesh=make_mesh(
                    self.parts, spatial=self.parts), tape=None))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=target, args=(i,)) for i in range(self.parts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


@pytest.fixture
def group(monkeypatch):
    groups = {}

    def make(parts):
        groups["g"] = _Group(parts)
        monkeypatch.setattr(S, "_sum_in_group", groups["g"].sum_)
        return groups["g"]

    return make


def _band(x, rows, parts, i):
    a, b = S.bands(rows, parts)[i]
    return x[:, a:b].clone().requires_grad_(x.requires_grad)


def test_bands_partition_every_plane_and_the_windows_cover_the_outputs():
    assert S.bands(7, 2) == ((0, 4), (4, 7)) and S.bands(224, 2) == ((0, 112), (112, 224))
    assert S.bands(1, 2) == ((0, 1), (1, 1))
    for rows, parts, k, stride in CASES:
        spans = S.bands(rows, parts)
        assert spans[0][0] == 0 and spans[-1][1] == rows
        assert all(a <= b and b == c for (a, b), (c, _) in zip(spans, spans[1:]))
        outs = S.bands(S.out_size(rows, k, stride), parts)
        for win, (c, d) in zip(S.conv_windows(rows, parts, k, stride), outs):
            assert win.count == d - c
            if win.count:  # the conv on [lo, hi) gives output c at `first`
                assert win.lo == max(c * stride - stride * -(-(k // 2) // stride), 0)
                assert (c * stride - win.lo) % stride == 0
                assert S.out_size(win.hi - win.lo, k, stride) >= win.first + win.count


@pytest.mark.parametrize("rows,parts,k,stride", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_exchange_gives_the_window_and_its_adjoint(group, rows, parts, k, stride, dtype):
    """Each rank's window is the whole plane's rows [lo, hi), bit for bit;
    the backward is the adjoint: in float64 sum_i <E_i x, g_i> = sum_i
    <x_i, (Eᵀ g)_i>, and the gradient of the whole plane is the windows'
    gradients added at their rows (in bf16 to its rounding). bf16 with 3
    channels and 5 columns sums uint8 words."""
    g = torch.Generator().manual_seed(rows * 31 + parts)
    x = torch.randn(1, rows, 5, 3, generator=g).to(dtype)
    windows = S.conv_windows(rows, parts, k, stride)
    grads = [torch.randn(1, w.hi - w.lo, 5, 3, generator=g).to(dtype) for w in windows]
    grp = group(parts)

    def rank(i, rep):
        band = _band(x.requires_grad_(False), rows, parts, i).requires_grad_(True)
        win = S.halo_rows(band, rep, rows, windows)
        (dx,) = torch.autograd.grad(win, band, grads[i])
        return win.detach(), dx

    out = grp.run(rank)
    whole = torch.zeros(1, rows, 5, 3, dtype=torch.float64)
    for (win, dx), w, gi in zip(out, windows, grads):
        assert torch.equal(win, x[:, w.lo:w.hi])
        whole[:, w.lo:w.hi] += gi.double()
    dxs = torch.cat([dx for _, dx in out], dim=1)
    if dtype == torch.float64:
        lhs = sum(float((win * gi).sum()) for (win, _), gi in zip(out, grads))
        rhs = float((x * dxs).sum())
        assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
        torch.testing.assert_close(dxs, whole, rtol=1e-12, atol=1e-12)
    else:  # a row's gradients add in bf16: one rounding each
        torch.testing.assert_close(dxs.double(), whole, rtol=2.0 ** -7, atol=2.0 ** -7)
    needed = any(w.lo < a or w.hi > b for w, (a, b) in zip(windows, S.bands(rows, parts))
                 if w.hi > w.lo)
    assert grp.calls == 2 * needed == 2 * S.exchanges(rows, parts, k, stride)


def _whole_vs_bands(grp, x, rows, parts, k, stride, fn, out_channels, params=()):
    """fn on the whole plane and on each rank's band (banded, in threads):
    the whole output and the bands' concatenated; with gradients when x
    requires them: dx and each param's gradient, whole and summed."""
    def run(xin, ps):
        y = fn(xin, ps)
        if not xin.requires_grad:
            return y.detach(), None, None
        gy = torch.ones_like(y) * torch.linspace(-1, 1, y.numel()).view_as(y).to(y.dtype)
        dx, *dps = torch.autograd.grad(y, [xin, *ps], gy)
        return y.detach(), dx, dps

    whole = run(x, params)

    def rank(i, rep):
        band = _band(x, rows, parts, i)
        ps = [p.detach().clone().requires_grad_(p.requires_grad) for p in params]
        return run2(band, ps, rep)

    def run2(band, ps, rep):
        y = S.banded(band, rep, k, stride, lambda w: fn(w, ps), out_channels, tuple(ps),
                     rows=rows)
        if not band.requires_grad:
            return y.detach(), None, None
        out_rows = S.bands(S.out_size(rows, k, stride), parts)
        a = out_rows[rep.rank][0]
        full = torch.linspace(-1, 1, whole[0].numel()).view_as(whole[0]).to(y.dtype)
        gy = full[:, a:a + y.shape[1]]
        dx, *dps = torch.autograd.grad(y, [band, *ps], gy, allow_unused=False)
        return y.detach(), dx, dps

    bands = grp.run(rank)
    y = torch.cat([b[0] for b in bands], dim=1)
    if not x.requires_grad:
        return whole[0], y
    dx = torch.cat([b[1] for b in bands], dim=1)
    dps = [sum(b[2][j] for b in bands) for j in range(len(params))]
    return whole, (y, dx, dps)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("rows,parts,k,stride", [c for c in CASES if c[0] >= 2])
def test_dw_training_op_on_bands_equals_the_whole_plane(group, rows, parts, k, stride):
    """The dw training op on the kernel route (its plain version here) on
    each band's window: the output rows, dx and the weight's gradient
    (summed over the ranks) of the whole plane's op."""
    g = torch.Generator().manual_seed(5)
    c = 8
    x = torch.randn(2, rows, 6, c, generator=g).requires_grad_(True)
    kernel = (torch.randn(k, k, 1, c, generator=g) * 0.3).requires_grad_(True)
    fn = lambda xin, ps: depthwise_conv2d(xin, ps[0], stride=stride, impl="kernel")  # noqa: E731
    whole, (y, dx, dps) = _whole_vs_bands(group(parts), x, rows, parts, k, stride, fn, c,
                                          (kernel,))
    assert y.shape == whole[0].shape
    assert _rel(y, whole[0]) <= 1e-6
    assert _rel(dx, whole[1]) <= 1e-5
    assert _rel(dps[0], whole[2][0]) <= 1e-5


@pytest.mark.parametrize("rows,parts,k,stride", [(14, 2, 5, 1), (7, 2, 3, 1), (14, 2, 3, 2),
                                                 (2, 2, 5, 1), (3, 4, 5, 1), (1, 2, 3, 1)])
def test_eval_kernels_on_bands_equal_the_whole_plane(group, rows, parts, k, stride):
    """The eval dw op and the fused MBConv block (their plain versions) on
    each band's window, cropped: the whole plane's output rows."""
    g = torch.Generator().manual_seed(6)
    cin, cmid, cout = 8, 24, 8

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    x = r(2, rows, 6, cin)
    dw_args = (r(k, k, 1, cin, scale=0.3), r(cin).abs() + 0.5, r(cin, scale=0.1))
    whole, y = _whole_vs_bands(group(parts), x, rows, parts, k, stride, lambda xin, _: (
        depthwise_conv_bn_relu_fused(xin, *dw_args, stride=stride, impl="kernel")), cin)
    assert _rel(y, whole) <= 1e-6
    mb = (r(cin, cmid, scale=cin ** -0.5), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
          r(k, k, 1, cmid, scale=1 / k), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
          r(cmid, cout, scale=cmid ** -0.5), r(cout).abs() + 0.5, r(cout, scale=0.1))
    kw = dict(kernel_size=k, stride=stride, residual=stride == 1)
    whole, y = _whole_vs_bands(group(parts), x, rows, parts, k, stride,
                               lambda xin, _: mbconv_fused(xin, *mb, **kw), cout)
    assert _rel(y, whole) <= 1e-6


@pytest.mark.parametrize("rows,parts", [(32, 2), (16, 4), (64, 2)])
@pytest.mark.parametrize("s2d", [True, False])
def test_stem_on_bands_equals_the_whole_plane(group, rows, parts, s2d):
    """The stem on each band of image rows, in its s2d form (train mode:
    the window starts on a pixel block, the zero row on top is the
    window's) and its plain form: the whole image's output rows, and the
    weight's gradient summed over the ranks."""
    weight = torch.randn(8, 3, 3, 3, generator=torch.Generator().manual_seed(7))
    x = torch.randn(2, rows, 10, 3, generator=torch.Generator().manual_seed(8))

    def stem():
        s = StemConv(8, s2d=s2d).train()
        with torch.no_grad():
            s.weight.copy_(weight)
        return s

    ref = stem()
    whole = nhwc(ref._conv(nchw(x), s2d))
    (dref,) = torch.autograd.grad(whole.sum(), [ref.weight])

    def rank(i, rep):
        s = stem()
        y = S.banded(_band(x, rows, parts, i), rep, 3, 2, lambda xw: nhwc(s._conv(nchw(xw), s2d)),
                     8, (s.weight,), rows=rows)
        (dw,) = torch.autograd.grad(y.sum(), [s.weight])
        return y.detach(), dw

    out = group(parts).run(rank)
    y = torch.cat([o[0] for o in out], dim=1)
    assert y.shape == whole.shape and _rel(y, whole.detach()) <= 1e-6
    assert _rel(sum(o[1] for o in out), dref) <= 1e-5


# ------------------------------------------------------------ no ranks
def test_mesh_layout_and_its_errors():
    """``make_mesh``'s layout (slice-major: dcn, data, spatial) and the
    reference's errors."""
    mesh = make_mesh(8, data=2, spatial=2, dcn=2)
    assert mesh.world == 8 and mesh.data_shards == 4
    # rank = (i_dcn·data + i_data)·spatial + i_spatial
    assert [(mesh.data_index(r), mesh.spatial_index(r)) for r in (0, 1, 2, 5, 7)] == [
        (0, 0), (0, 1), (1, 0), (2, 1), (3, 1)]
    assert make_mesh(4, spatial=2) == (1, 2, 2) and make_mesh(4) == (1, 4, 1)
    for kw, msg in ((dict(data=3), "mesh 1x3x1 != 4 devices"),
                    (dict(spatial=3), "mesh 1x1x3 != 4 devices"),
                    (dict(dcn=3), "mesh 3x1x1 != 4 devices"),
                    (dict(data=2, spatial=4), "mesh 1x2x4 != 4 devices"),
                    (dict(spatial=0), "must be >= 1")):
        with pytest.raises(ValueError, match=msg):
            make_mesh(4, **kw)
    rep = Replicas(1, 2, "cpu")
    with pytest.raises(ValueError, match="mesh 1x2x2 != 2 devices"):
        M.use_mesh(rep, make_mesh(4, spatial=2))
    rep.mesh = make_mesh(2, spatial=2)
    with pytest.raises(ValueError, match="do not divide"):
        take_band(torch.zeros(2, 7, 4, 3), rep)
    with pytest.raises(ValueError, match="data shards"):
        shard_batch(Replicas(1, 2, "cpu"), torch.zeros(3, 4, 4, 3), torch.zeros(3))
    assert take_band(torch.arange(16.).view(1, 4, 4, 1), rep)[0, :, 0, 0].tolist() == [8, 12]
    # Two planes of a 4-rank group that both leave rank 3 without rows, with
    # other global counts: the band plan cannot tell them apart.
    rep4 = Replicas(3, 4, "cpu")
    rep4.mesh, rep4.spatial_counts, rep4.spatial_planes = make_mesh(4, spatial=4), {}, {}
    with pytest.raises(ValueError, match="the same rows per channel 0"):
        M.register_planes(rep4, 2, [(2, 2), (1, 1)])


@pytest.mark.parametrize("mesh,msg", [((1, 1, 2), "requires spatial mesh axis of size 1"),
                                      ((2, 1, 1), "shards only over 'data'")])
def test_local_bn_refuses_spatial_and_dcn_meshes(mesh, msg):
    """``make_local_bn_train_step`` raises the reference's errors
    (``mnasnet_tpu/train/steps.py:272-277``)."""
    model = create_model("mnasnet0_35", device="cpu", num_classes=8)
    rep = Replicas(0, 2, "cpu")
    rep.mesh = M.Mesh(*mesh)
    with pytest.raises(ValueError, match=msg):
        make_local_bn_train_step(model, create_optimizer("sgd", 0.1), 0.1, rep)


# --------------------------------------------------------- spawned ranks
def _jax_model(**kw):
    return JaxMNASNet(alpha=W.ALPHA, num_classes=W.CLASSES, dropout=0.0, dw_impl="xla",
                      precision="highest", bn_ema="external", stem_s2d=True, **kw)


def _perturbed(variables, rng):
    def walk(tree, kind):
        for key, val in tree.items():
            if isinstance(val, dict) and set(val) == {"scale", "bias"}:
                val["scale"] = rng.uniform(0.5, 1.5, val["scale"].shape).astype(np.float32)
                val["bias"] = (rng.standard_normal(val["bias"].shape) * 0.1).astype(np.float32)
            elif isinstance(val, dict) and set(val) == {"mean", "var"}:
                val["mean"] = (rng.standard_normal(val["mean"].shape) * 0.1).astype(np.float32)
                val["var"] = rng.uniform(0.5, 1.5, val["var"].shape).astype(np.float32)
            elif isinstance(val, dict):
                walk(val, kind)

    walk(variables["params"], "params")
    walk(variables["batch_stats"], "stats")
    variables["params"]["classifier"]["kernel"] *= 0.05
    return variables


def _jax_runs(variables):
    """The reference's ``Trainer`` step on the one-device, ``data=2`` and
    1x2 meshes (the BN EMA's decay 0: the running statistics after the step
    are its batch moments), and the eval forward on the one-device and 1x2
    meshes."""
    images, labels = (t.numpy() for t in W.batch(torch.float32))
    model = _jax_model(bn_momentum=0.0)
    tx = jax_create_optimizer("sgd", 1e-3)
    devices = jax.devices()
    out = {}
    for name, mesh in (("one", jax_make_mesh(devices[:1])),
                       ("data2", jax_make_mesh(devices[:2])),
                       ("sp", jax_make_mesh(devices[:2], data=1, spatial=2))):
        trainer = JaxTrainer(model, tx, mesh=mesh, label_smoothing=0.1, print_freq=10 ** 6)
        state = replicate_state(mesh, JaxTrainState.create(
            jax.tree.map(jnp.asarray, variables["params"]),
            jax.tree.map(jnp.asarray, variables["batch_stats"]), tx, jax.random.PRNGKey(0)))
        state, metrics = trainer._train_step(state, jnp.asarray(images), jnp.asarray(labels))
        run = {"loss": float(metrics["loss"]),
               "params": params_from_jax(jax.tree.map(np.asarray, state.params), W.ALPHA),
               "stats": stats_from_jax(jax.tree.map(np.asarray, state.batch_stats), W.ALPHA)}
        if name != "data2":
            forward = jax.jit(lambda v, x: model.apply(v, x, train=False),
                              in_shardings=(replicated(mesh), batch_sharding(mesh)),
                              out_shardings=replicated(mesh))
            run["logits"] = np.asarray(forward(jax.tree.map(jnp.asarray, variables), images))
        out[name] = run
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("spatial")
    variables = JaxMNASNet(alpha=W.ALPHA, num_classes=W.CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, W.IMAGE, W.IMAGE, 3)), train=False)
    variables = _perturbed(jax.tree.map(np.array, variables), np.random.default_rng(11))
    sd = state_dict_from_jax(variables, W.ALPHA)
    torch.save(sd, work / "weights.pt")
    ctxs = {world: mp.start_processes(W.run, args=(world, str(work / f"rdv{world}"), str(work),
                                                   str(work / "weights.pt")),
                                      nprocs=world, join=False, start_method="spawn")
            for world in (2, 4)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _jax_runs(variables)
        one = {"step": W.step_run(), "trainer": W.trainer_run(),
               "fp32": W.step_run(dtype=torch.float32, steps=1, sd=sd, dropout=0.0)}
    finally:
        torch.set_num_threads(threads)
    for world, ctx in ctxs.items():
        for proc in ctx.processes:
            proc.join(SPAWN_TIMEOUT_S)
        alive = [p.pid for p in ctx.processes if p.is_alive()]
        for p in ctx.processes:
            p.kill()
        assert not alive, f"world {world}: ranks still running after {SPAWN_TIMEOUT_S} s"
        assert [p.exitcode for p in ctx.processes] == [0] * world, \
            f"world {world}: rank exit codes {[p.exitcode for p in ctx.processes]}"
    ranks = {world: [torch.load(work / f"world{world}_rank{r}.pt", weights_only=False)
                     for r in range(world)] for world in (2, 4)}
    return {"jax": ref, "one": one, "ranks": ranks, "sd": sd}


def _rel_rms(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def _update_rel_rms(ours, ref, p0):
    """|Δp_ours − Δp_ref| / |Δp_ref| over all parameters, in float64."""
    def f64(t):
        return np.asarray(t, dtype=np.float64)

    num = sum(float(((f64(ours[n]) - f64(ref[n])) ** 2).sum()) for n in ref)
    den = sum(float(((f64(ref[n]) - f64(p0[n])) ** 2).sum()) for n in ref)
    return (num / den) ** 0.5


def _assert_same_on_every_rank(ranks, key):
    a = ranks[0][key]
    for r in ranks[1:]:
        for field in ("params", "stats"):
            for n in a[field]:
                assert torch.equal(a[field][n], r[key][field][n]), (key, field, n)


@pytest.mark.parametrize("world", [2, 4])
def test_sync_bn_step_over_the_mesh_equals_one_process_in_float64(runs, world):
    """1x2 (world 2) and 2x2 (world 4): two float64 sync-BN steps with
    dropout on, every rank on its band of its shard, against one process on
    the whole batch; the eval forward before them; the collectives each
    makes, against ``step_collectives`` and ``MNASNet.spatial_collectives``."""
    ranks, one = runs["ranks"][world], runs["one"]["step"]
    _assert_same_on_every_rank(ranks, "step")
    p0 = {n: p.detach() for n, p in W.model().named_parameters()}
    shard = W.BATCH // (world // 2)
    for rank, r in enumerate(ranks):
        ours = r["step"]
        rows = slice(rank // 2 * shard, (rank // 2 + 1) * shard)
        assert ours["counts"] == one["counts"]
        np.testing.assert_allclose(ours["losses"], one["losses"], rtol=2.0 ** -22)
        assert _update_rel_rms(ours["params"], one["params"], p0) <= F64_BAR
        for n, v in one["stats"].items():
            assert _rel_rms(ours["stats"][n], v) <= F64_BAR, n
        assert _rel_rms(ours["logits"], one["logits"][rows]) <= F64_BAR
        assert ours["collectives"] == [ours["predicted"]] * 2
        assert ours["eval_collectives"] == ours["eval_predicted"]


@pytest.mark.parametrize("world", [2, 4])
def test_remat_over_the_mesh_is_the_plain_step_bit_for_bit(runs, world):
    """Rematerialised blocks replay their forward's halo rows and sums: the
    same step, bit for bit, and the same collectives."""
    for r in runs["ranks"][world]:
        for field in ("params", "stats"):
            for n, v in r["step"][field].items():
                assert torch.equal(r["remat"][field][n], v), n
        assert r["remat"]["collectives"] == r["step"]["collectives"]


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_validation_and_recal_over_the_mesh_equal_one_process(runs, world):
    """The ``Trainer`` on data-shard loaders, each rank taking its band: an
    epoch of 3 steps, the validation of 13 images (each counted once: the
    second rank of a spatial group adds nothing), then recalibration, in
    float64, against one process."""
    one = runs["one"]["trainer"]
    p0 = {n: p.detach() for n, p in W.model(dropout=0.0).named_parameters()}
    for r in runs["ranks"][world]:
        ours = r["trainer"]
        assert _update_rel_rms(ours["train"]["params"], one["train"]["params"], p0) <= F64_BAR
        assert ours["validation"][:2] == one["validation"][:2]
        np.testing.assert_allclose(ours["validation"][2], one["validation"][2], rtol=2.0 ** -22)
        for n, v in one["recal"].items():
            assert _rel_rms(ours["recal"][n], v) <= F64_BAR, n
    assert 0 < one["validation"][1] <= 100


def test_dcn_mesh_equals_the_flat_data_mesh_bit_for_bit(runs):
    """``make_mesh(2, dcn=2)`` against ``make_mesh(2)``: the batch shards over
    ``dcn × data`` as over ``data``, every collective is world-wide."""
    for r in runs["ranks"][2]:
        assert r["dcn"]["losses"] == r["flat"]["losses"]
        assert r["dcn"]["collectives"] == [r["flat"]["predicted"]]
        for field in ("params", "stats"):
            for n, v in r["flat"][field].items():
                assert torch.equal(r["dcn"][field][n], v), n


def _moment_diffs(ours, ref):
    """Per BN: each channel's mean in units of its standard deviation, each
    variance relative to itself (the largest over the channels)."""
    worst = 0.0
    for n, v in ref.items():
        if n.endswith("running_var"):
            m = n[:-len("var")] + "mean"
            sd = np.sqrt(np.maximum(np.asarray(v), 1e-12))
            worst = max(worst, float((np.abs(np.asarray(ours[m]) - ref[m]) / sd).max()),
                        float((np.abs(np.asarray(ours[n]) - v) / np.maximum(v, 1e-12)).max()))
    return worst


def test_forward_over_the_mesh_matches_the_reference_trainer(runs):
    """fp32, the kernel route: the eval logits (before the step), the step's
    loss and its BN moments on the port's 1x2 mesh against the reference's
    ``Trainer`` on ``make_mesh(devices[:2], data=1, spatial=2)``, within 4
    times the reference's own one-device vs 1x2 spread or 1e-5."""
    ref, sp = runs["jax"]["one"], runs["jax"]["sp"]
    ours = runs["ranks"][2][0]["fp32"]
    logits = ours["logits"].numpy()
    scale = float(np.abs(sp["logits"]).max())
    spread = float(np.abs(ref["logits"] - sp["logits"]).max())
    assert float(np.abs(logits - sp["logits"]).max()) <= max(1e-5 * scale, SPREAD * spread)
    loss_spread = abs(ref["loss"] - sp["loss"]) / abs(sp["loss"])
    assert abs(ours["losses"][0] - sp["loss"]) / abs(sp["loss"]) <= max(1e-5,
                                                                        SPREAD * loss_spread)
    stats = {n: v.numpy() for n, v in ours["stats"].items()}
    assert _moment_diffs(stats, sp["stats"]) <= max(1e-5, SPREAD * _moment_diffs(ref["stats"],
                                                                                 sp["stats"]))


def test_step_over_the_mesh_matches_the_reference_step(runs):
    """fp32: the port's 1x2 step against the reference's 1x2 step, held to 4
    times the reference's own spread between its one-device and ``data=2``
    meshes at this setting (relative RMS of the update); the port's one
    process against the reference's one device to the same bar."""
    ref = runs["jax"]
    m = W.model(torch.float32, dropout=0.0, momentum=0.0)
    m.load_state_dict(runs["sd"])
    p0 = {n: p.detach().numpy() for n, p in m.named_parameters()}
    spread = _update_rel_rms(ref["data2"]["params"], ref["one"]["params"], p0)
    bar = SPREAD * spread
    ours = runs["ranks"][2][0]["fp32"]
    assert _update_rel_rms(ours["params"], ref["sp"]["params"], p0) <= bar
    assert _update_rel_rms(runs["one"]["fp32"]["params"], ref["one"]["params"], p0) <= bar

