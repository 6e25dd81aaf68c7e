"""The port's data parallelism on the CPU: two ranks of a gloo group, spawned
(``torch.multiprocessing``, spawn start method, ``file://`` rendezvous),
against one process and against the JAX package.

The two workers (``tests/torch_parallel_worker.py``, which imports no JAX)
run every 2-rank scenario once, in one spawn for the whole module, while
this process jits the JAX steps; each test then holds one scenario. The
configuration is mnasnet0_35, 8 classes, fp32, the kernel route (the
kernels' plain versions), external BN EMA, s2d stem, RMSProp 1e-4
``fused="small"``: the steps at 64 px with 8 images per rank, the trainer
runs at 32 px with 4 per rank. The weights are the JAX init with its BN
affine perturbed (as in ``tests/test_torch_train.py``), given to both
packages.

Tolerances, each with its reason:
  * BN region and moments, 2 ranks against the whole batch: rtol 1e-5, atol
    1e-6 — the same fp32 sums taken in halves, then added;
  * the sync-BN step against one process on the concatenated batch (dropout
    on, one-pass moments, two steps): the moments' sums are taken in another
    order, a rounding that the batch-statistic BN backward amplifies at
    random init as it amplifies a one-ulp change of the images (measured:
    the 2-rank step moves parameters by up to ~15 times the one-process
    step's own move under a one-ulp change of its images). So each value is
    held to rtol 1e-5, atol 1e-6 plus SPREAD (25) times that own move, the
    bound of ``tests/test_torch_train.py`` with the port as its own
    reference;
  * against JAX ``make_train_step`` and ``make_local_bn_train_step``: the
    bound of ``tests/test_torch_train.py`` for one step, rtol 5e-3 and atol
    1e-4 plus 25 times the reference's own move when its images change by
    one ulp;
  * the local-BN step against the port's ``grad_accum=2`` step: bit for bit
    (the same microbatches, the same weighted sums; gloo adds two ranks'
    values as the accumulation adds two microbatches');
  * recalibration over 2 ranks against one process: 1e-4 of each buffer's
    largest value plus 1e-6 (measured up to 1.9e-5 of the largest value: the
    moments' sums in another order, compounded through a forward of 52
    batch-statistic BatchNorms; the 1e-6 is the rounding of a sum of O(1)
    activations, for means that are ~0);
  * validation sums: top-1/top-5 exactly, loss rtol 1e-6;
  * the stop and the checkpoint: steps and writes exactly, the restored
    state bit for bit at both world sizes; the two steps after the resume
    (32 px, 4 images a rank, where the last stages normalise over 8 values)
    at 1e-2 relative RMS of the update over all parameters, the criterion
    ``chip_smoke.py`` holds the kernel route to against the torch route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_worker as W
from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.parallel.mesh import batch_sharding, label_sharding, make_mesh
from mnasnet_tpu.parallel.mesh import replicate_state, replicated
from mnasnet_tpu.train.optim import create_optimizer as jax_create_optimizer
from mnasnet_tpu.train.state import TrainState as JaxTrainState
from mnasnet_tpu.train.steps import make_local_bn_train_step as jax_make_local_bn_train_step
from mnasnet_tpu.train.steps import make_train_step as jax_make_train_step
from mnasnet_tpu_torch.convert.torch_converter import (
    params_from_jax,
    state_dict_from_jax,
    stats_from_jax,
)
from mnasnet_tpu_torch.train.steps import step_collectives

SPREAD = 25.0  # tests/test_torch_train.py's multiple of the reference's spread
SPAWN_TIMEOUT_S = 240


def _perturb_affine(tree, rng):
    for val in tree.values():
        if isinstance(val, dict):
            if set(val) == {"scale", "bias"}:
                val["scale"] = rng.uniform(0.5, 1.5, val["scale"].shape).astype(np.float32)
                val["bias"] = (rng.standard_normal(val["bias"].shape) * 0.1).astype(np.float32)
            else:
                _perturb_affine(val, rng)


def _jax_model():
    return JaxMNASNet(alpha=W.ALPHA, num_classes=W.CLASSES, dropout=0.0, dw_impl="xla",
                      precision="highest", bn_stats="two_pass", bn_ema="external",
                      stem_s2d=True)


def _jax_run(step, tx, variables, images, labels, mesh=None):
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                                 jax.tree.map(jnp.asarray, variables["batch_stats"]), tx,
                                 jax.random.PRNGKey(0))
    if mesh is not None:
        state = replicate_state(mesh, state)
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels))
    return {"loss": float(metrics["loss"]),
            "params": params_from_jax(jax.tree.map(np.asarray, state.params), W.ALPHA),
            "stats": stats_from_jax(jax.tree.map(np.asarray, state.batch_stats), W.ALPHA)}


def _jax_runs(variables, images, labels):
    """Per step (sync-BN on the concatenated batch, local BN on a 2-device
    mesh): the reference's result and its result on images moved by one
    ulp."""
    nudged = _nudged(images)
    model = _jax_model()
    tx = jax_create_optimizer("rmsprop", 1e-4, fused="small")
    sync = jax.jit(jax_make_train_step(model, tx, 0.1))
    mesh = make_mesh(jax.devices()[:W.WORLD])
    local = jax.jit(jax_make_local_bn_train_step(model, tx, 0.1, mesh=mesh),
                    in_shardings=(replicated(mesh), batch_sharding(mesh), label_sharding(mesh)),
                    out_shardings=(replicated(mesh), replicated(mesh)))
    return {"sync": [_jax_run(sync, tx, variables, x, labels) for x in (images, nudged)],
            "local": [_jax_run(local, tx, variables, x, labels, mesh) for x in (images, nudged)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results (spawned once) and the JAX runs, made while
    the ranks run."""
    work = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(11)
    variables = JaxMNASNet(alpha=W.ALPHA, num_classes=W.CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, W.STEP_IMAGE, W.STEP_IMAGE, 3)), train=False)
    variables = jax.tree.map(np.array, variables)
    _perturb_affine(variables["params"], rng)
    variables["params"]["classifier"]["kernel"] *= 0.05
    sd = state_dict_from_jax(variables, W.ALPHA)
    torch.save(sd, work / "weights.pt")
    # The ranks start from the worker module, which imports no JAX.
    ctx = mp.start_processes(W.run, args=(str(work / "rendezvous"), str(work)),
                             nprocs=W.WORLD, join=False, start_method="spawn")
    images, labels = W.step_case()
    ref = _jax_runs(variables, images, labels)
    for proc in ctx.processes:
        proc.join(SPAWN_TIMEOUT_S)
    alive = [p.pid for p in ctx.processes if p.is_alive()]
    for p in ctx.processes:
        p.kill()
    assert not alive, f"ranks still running after {SPAWN_TIMEOUT_S} s: {alive}"
    assert [p.exitcode for p in ctx.processes] == [0, 0], \
        f"rank exit codes {[p.exitcode for p in ctx.processes]} (see the captured stderr)"
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(W.WORLD)]
    return {"sd": sd, "images": images, "labels": labels, "jax": ref, "ranks": ranks,
            "work": work}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def _assert_close_dicts(ours, ref, rtol, atol, what):
    assert ours.keys() == ref.keys(), what
    for n in ref:
        np.testing.assert_allclose(np.asarray(ours[n]), np.asarray(ref[n]), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {n}")


def _assert_replicated(ranks, key, fields=("params", "stats")):
    """Every rank ends the step with rank 0's state, bit for bit."""
    a, b = ranks[0][key], ranks[1][key]
    for f in fields:
        _assert_tree_equal(a[f], b[f])
    assert a["losses"] == b["losses"] and a["counts"] == b["counts"]


@pytest.mark.parametrize("route", ["kernel", "torch"])
@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_bn_region_over_two_ranks_equals_the_whole_batch(runs, route, stats):
    """The BN+ReLU region with a group of 2 on two halves of x: dx is the
    whole batch's dx, half by half; dγ and dβ, the gradients of each rank's
    share, sum to the whole batch's; the torch route's running statistics
    are the whole batch's on both ranks."""
    x, dy, gamma, beta = W.bn_case()
    whole = W.bn_run(route, stats, x, dy, gamma, beta)
    halves = [r["bn"][route, stats] for r in runs["ranks"]]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat([h["dx"] for h in halves]).numpy(),
                               whole["dx"].numpy(), **tol)
    for key in ("dgamma", "dbeta"):
        np.testing.assert_allclose((halves[0][key] + halves[1][key]).numpy(),
                                   whole[key].numpy(), **tol, err_msg=key)
    for h in halves:
        for a, b in zip(h.get("running", ()), whole.get("running", ())):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    assert ("running" in whole) == (route == "torch")


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_batch_moments_over_two_ranks_equal_the_whole_batch(runs, stats):
    x = W.bn_case()[0]
    from mnasnet_tpu_torch.ops.cuda.bn_bwd import batch_moments

    mean, var = batch_moments(x, stats)
    for r in runs["ranks"]:
        for route in ("kernel", "torch"):
            m, v = r["bn"][route, stats]["moments"]
            np.testing.assert_allclose(m.numpy(), mean.numpy(), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(v.numpy(), var.numpy(), rtol=1e-5, atol=1e-6)


def test_sync_bn_step_equals_one_process_on_the_concatenated_batch(runs):
    """Two steps, dropout on: the global batch's one mask, each rank its rows."""
    ranks = runs["ranks"]
    _assert_replicated(ranks, "sync_dropout")
    ours = ranks[0]["sync_dropout"]
    one, moved = (W.port_step(runs["sd"], x, runs["labels"], dropout=0.2, stats="one_pass",
                              steps=2) for x in (runs["images"], _nudged(runs["images"])))
    assert ours["counts"] == one["counts"] and one["counts"][0][2] == W.STEP_BATCH - 2
    _close_to_own_spread(ours["losses"], one["losses"], moved["losses"], "losses")
    for field in ("params", "stats"):
        assert ours[field].keys() == one[field].keys()
        for n in one[field]:
            _close_to_own_spread(ours[field][n], one[field][n], moved[field][n], f"{field} {n}")


def _nudged(images):
    """The images moved by one ulp, each up or down."""
    return (images * (1 + 2.0 ** -23 * np.random.default_rng(12).choice(
        [-1.0, 1.0], images.shape))).astype(np.float32)


def _close_to_own_spread(ours, ref, moved, what):
    ours, ref, moved = (np.asarray(v, dtype=np.float64) for v in (ours, ref, moved))
    spread = float(np.abs(ref - moved).max())
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6 + SPREAD * spread, err_msg=what)


def test_sync_bn_step_collectives_are_the_predicted_ones(runs):
    """The second step issues exactly what ``step_collectives`` predicts; the
    first adds one check of each new BN plane size."""
    ours = runs["ranks"][0]["sync_dropout"]["collectives"]
    model = W._model(None, 0.2, "one_pass")
    assert ours[1] == step_collectives(model)
    planes = {(W.STEP_IMAGE // 2) ** 2, (W.STEP_IMAGE // 4) ** 2, (W.STEP_IMAGE // 8) ** 2,
              (W.STEP_IMAGE // 16) ** 2, (W.STEP_IMAGE // 32) ** 2}
    assert ours[0] == ours[1] + len(planes)
    assert runs["ranks"][0]["local"]["collectives"] == [step_collectives(model, sync_bn=False)]


@pytest.mark.parametrize("key", ["sync_dropout", "sync"])
def test_sync_bn_remat_step_is_the_step_bit_for_bit(runs, key):
    """Sync-BN with rematerialised blocks (one_pass with dropout over 2
    steps; two_pass): on each rank the losses, counts, parameters and BN
    statistics of the step without ``remat``, bit for bit (that step is
    held against one process above), and the same collectives, which
    ``step_collectives`` predicts: the recompute normalises with the
    forward's global moments and issues none."""
    for rank in runs["ranks"]:
        plain, remat = rank[key], rank[f"{key}_remat"]
        assert remat["losses"] == plain["losses"] and remat["counts"] == plain["counts"]
        # The first step of a process also checks each new BN plane size
        # once; the plain run came first.
        assert remat["collectives"][-1] == plain["collectives"][-1]
        for field in ("params", "stats"):
            _assert_tree_equal(remat[field], plain[field])
    stats = "one_pass" if key == "sync_dropout" else "two_pass"
    model = W._model(None, 0.2, stats, remat=True)
    assert runs["ranks"][0][f"{key}_remat"]["collectives"][-1] == step_collectives(model)
    _assert_replicated(runs["ranks"], f"{key}_remat")


def _close_to_jax(ours, ref, moved, what):
    ours, ref, moved = np.asarray(ours), np.asarray(ref), np.asarray(moved)
    spread = float(np.abs(ref - moved).max())
    np.testing.assert_allclose(ours, ref, rtol=5e-3, atol=1e-4 + SPREAD * spread, err_msg=what)


@pytest.mark.parametrize("kind", ["sync", "local"])
def test_two_rank_step_matches_jax(runs, kind):
    """sync: the 2-rank sync-BN step against JAX ``make_train_step`` on the
    concatenated batch; local: the 2-rank local-BN step against JAX
    ``make_local_bn_train_step`` on a 2-device mesh. Dropout 0, two-pass."""
    _assert_replicated(runs["ranks"], kind)
    ours = runs["ranks"][0][kind]
    ref, moved = runs["jax"][kind]
    _close_to_jax(ours["losses"][0], ref["loss"], moved["loss"], "loss")
    for field in ("params", "stats"):
        assert ours[field].keys() == ref[field].keys()
        for n in ref[field]:
            _close_to_jax(ours[field][n].numpy(), ref[field][n], moved[field][n], f"{field} {n}")


def test_local_bn_step_equals_the_grad_accum_2_step(runs):
    """The reference's own equivalence (``steps.py:96-106``), dropout on."""
    _assert_replicated(runs["ranks"], "local_dropout")
    ours = runs["ranks"][0]["local_dropout"]
    accum = W.port_step(runs["sd"], runs["images"], runs["labels"], dropout=0.2,
                        stats="one_pass", grad_accum=2)
    assert ours["losses"] == accum["losses"] and ours["counts"] == accum["counts"]
    _assert_tree_equal(ours["params"], accum["params"])
    _assert_tree_equal(ours["stats"], accum["stats"])


def test_recalibration_over_two_ranks_equals_one_process(runs):
    a, b = (r["recal"] for r in runs["ranks"])
    _assert_tree_equal(a, b)
    one = W.recal_run()
    assert a.keys() == one.keys()
    for n, v in one.items():
        np.testing.assert_allclose(a[n].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * float(v.abs().max()) + 1e-6, err_msg=n)


def test_validation_sums_over_two_ranks_equal_one_process(runs):
    """13 images, 4 per rank: each rank has a padded tail, and rank 1's shard
    ends with the wrap-padding duplicate; each image counts once."""
    one = W.validation_run()
    for acc1, acc5, loss in (r["validation"] for r in runs["ranks"]):
        assert (acc1, acc5) == one[:2]
        np.testing.assert_allclose(loss, one[2], rtol=1e-6)
    assert 0 < one[1] < 100


def test_a_stop_on_one_rank_stops_both_at_the_same_step(runs):
    """Rank 1 alone asks after step 1; the flag it sets is agreed before
    step 2 and read before step 3, so both ranks stop there; rank 0 alone
    writes the checkpoint."""
    a, b = (r["stop"] for r in runs["ranks"])
    for s in (a, b):
        assert s["stopped_early"] and s["next_global_step"] == W.STOP_AFTER + 2
        assert s["steps_run"] == W.STOP_AFTER + 2
    assert a["writes"] == [W.STOP_AFTER + 2] and b["writes"] == []


def test_resume_at_world_one_equals_world_two(runs):
    """The checkpoint written at world 2 restores the same state at world 1,
    bit for bit, and the rest of the epoch ends where the 2 ranks ended."""
    a, b = (r["stop"] for r in runs["ranks"])
    restored, final = W.resume_and_finish(str(runs["work"] / "ckpt"), a["next_global_step"])
    _assert_tree_equal(a["restored"], restored)
    _assert_tree_equal(b["restored"], restored)
    _assert_tree_equal(a["final"], b["final"])
    assert final["train_state"]["step"] == a["final"]["train_state"]["step"] == \
        W.TRAINER_SAMPLES // W.TRAINER_BATCH
    p0, p1, p2 = restored["model"], final["model"], a["final"]["model"]
    names = [n for n, v in p0.items() if v.is_floating_point()]
    den = sum(float(((p1[n] - p0[n]) ** 2).sum()) for n in names)
    num = sum(float(((p2[n] - p1[n]) ** 2).sum()) for n in names)
    assert den > 0 and (num / den) ** 0.5 <= 1e-2, (num / den) ** 0.5


def test_one_process_helpers_launch_nothing():
    """``replicas=None`` is one process: no group is joined, every helper
    returns its input untouched."""
    from mnasnet_tpu_torch import parallel

    assert parallel.init_distributed() is None
    assert (parallel.rank(), parallel.world_size()) == (0, 1)
    t = torch.arange(4.0)
    parallel.all_reduce_sum_([t], None)
    parallel.broadcast_([t], None)
    assert parallel.all_reduce_sum(t, None) is t and parallel.all_reduce_max_(t, None) is t
    assert torch.equal(t, torch.arange(4.0))
    assert parallel.global_rows(7, None) == 7 and parallel.broadcast_seed(5, None) == 5
    assert parallel.Flag(True, None).get() and not parallel.Flag(False, None).get()
    parallel.barrier(None)
    parallel.assert_replicated([t], None, "t")


@pytest.mark.parametrize("n,shards,batch", [(13, 2, 4), (10, 4, 3), (7, 3, 4), (8, 2, 4)])
def test_sharded_loader_counts_each_sample_once(n, shards, batch):
    """Without drop_last every shard has one length; the wrap-padding that
    makes it so, and each shard's padded tail, carry label -1, so the
    shards' valid labels are the dataset's, once each."""
    from mnasnet_tpu_torch.data.dataset import SyntheticDataset
    from mnasnet_tpu_torch.data.pipeline import DataLoader

    ds = SyntheticDataset(n, 8, 5, seed=2)
    valid = []
    for r in range(shards):
        loader = DataLoader(ds, batch, lambda img: np.zeros((8, 8, 3), np.float32),
                            drop_last=False, workers=0, augment=False, shard_id=r,
                            num_shards=shards)
        batches = list(loader.epoch(0))
        assert len(batches) == loader.steps_per_epoch()
        valid += [int(v) for _, labels in batches for v in labels if v >= 0]
    assert sorted(valid) == sorted(ds.load(i)[1] for i in range(n))
