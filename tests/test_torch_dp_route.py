"""The data-parallel train step's route (``utils/routing.py``,
``parallel/dist.py``, ``train/steps.py``) on the CPU: two ranks of a gloo
group (spawned from ``tests/torch_dp_route_worker.py``, which imports no
JAX) and one-rank groups in this process.

* Route resolution: the graph route for NCCL replicas on the card, eager
  for gloo's; the graph route with gloo, and the compile route with any
  replicas, raise, asked for or set in the environment.
* No host read after the warm-up: after its first step, the device part of
  the sync-BN, local-BN, ``grad_accum=2`` and ``remat`` steps runs with
  ``Tensor.item``, ``tolist``, ``__bool__``, ``__float__`` and ``__int__``
  patched to raise, as a CUDA graph capture of it would require.
* Collectives: each of those steps issues exactly ``step_collectives``.
* The capture guard: ``global_rows`` raises for a plane size it has not
  seen when the current stream reports a capture, and answers a seen one.
* Leaving the group: ``close`` resets every graph registered with the
  replicas, wherever it is still held, before it destroys the group.
* Parity: the first sync-BN step of the two ranks, taken through the
  ``Trainer``'s route, against JAX ``make_train_step`` on the concatenated
  batch, within the bars of tests/test_torch_parallel.py (rtol 5e-3, atol
  1e-4 plus 25 times the reference's own move when its images change by
  one ulp).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_dp_route_worker as W
import torch_parallel_worker as P
from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.train.optim import create_optimizer as jax_create_optimizer
from mnasnet_tpu.train.steps import make_train_step as jax_make_train_step
from mnasnet_tpu_torch.convert.torch_converter import state_dict_from_jax
from mnasnet_tpu_torch.parallel import Replicas, close, global_rows
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.steps import (
    make_local_bn_train_step,
    make_train_step,
    step_collectives,
)
from mnasnet_tpu_torch.utils.routing import TrainRouted, default_train_route
from test_torch_parallel import _close_to_jax, _jax_model, _jax_run, _nudged, _perturb_affine

ENV = "MNASNET_TPU_TORCH_ROUTE"
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' scenarios (spawned once) and the JAX sync-BN step on
    the concatenated batch and on it moved by one ulp, made meanwhile."""
    work = tmp_path_factory.mktemp("dp_route")
    variables = JaxMNASNet(alpha=P.ALPHA, num_classes=P.CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, P.STEP_IMAGE, P.STEP_IMAGE, 3)), train=False)
    variables = jax.tree.map(np.array, variables)
    _perturb_affine(variables["params"], np.random.default_rng(11))
    variables["params"]["classifier"]["kernel"] *= 0.05
    torch.save(state_dict_from_jax(variables, P.ALPHA), work / "weights.pt")
    ctx = mp.start_processes(W.run, args=(str(work / "rendezvous"), str(work)),
                             nprocs=P.WORLD, join=False, start_method="spawn")
    images, labels = P.step_case()
    tx = jax_create_optimizer("rmsprop", 1e-4, fused="small")
    step = jax.jit(jax_make_train_step(_jax_model(), tx, 0.1))
    ref = [_jax_run(step, tx, variables, x, labels) for x in (images, _nudged(images))]
    for proc in ctx.processes:
        proc.join(SPAWN_TIMEOUT_S)
    alive = [p.pid for p in ctx.processes if p.is_alive()]
    for p in ctx.processes:
        p.kill()
    assert not alive, f"ranks still running after {SPAWN_TIMEOUT_S} s: {alive}"
    assert [p.exitcode for p in ctx.processes] == [0, 0], \
        f"rank exit codes {[p.exitcode for p in ctx.processes]} (see the captured stderr)"
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(P.WORLD)]
    return {"jax": ref, "ranks": ranks}


def _replicas(backend):
    return types.SimpleNamespace(world=2, rank=0, backend=backend)


def _cpu_step_parts():
    model = P._model(None, 0.0, "two_pass")
    return model, create_optimizer("rmsprop", 1e-4, fused="small")


# ------------------------------------------------------- route resolution


@pytest.mark.parametrize("backend,device,route", [
    ("nccl", "cuda", "graph"), ("nccl", "cuda:1", "graph"), ("gloo", "cuda", "eager"),
    ("gloo", "cpu", "eager"), ("nccl", "cpu", "eager"),
])
def test_default_route_by_backend_and_device(monkeypatch, backend, device, route):
    monkeypatch.delenv(ENV, raising=False)
    assert default_train_route(device, _replicas(backend)) == route


@pytest.mark.parametrize("env,backend,route", [
    ("eager", "nccl", "eager"), ("none", "nccl", "eager"), ("graph", "nccl", "graph"),
    ("eager", "gloo", "eager"),
])
def test_the_environment_selects_or_disables_the_route(monkeypatch, env, backend, route):
    monkeypatch.setenv(ENV, env)
    assert default_train_route("cuda", _replicas(backend)) == route


@pytest.mark.parametrize("env,backend,match", [
    ("graph", "gloo", "gloo"), ("compile", "gloo", "compile"), ("compile", "nccl", "compile"),
])
def test_an_environment_asking_for_a_route_the_replicas_cannot_take_raises(
        monkeypatch, env, backend, match):
    """The environment's route is resolved as asked; the step built on it
    raises (``TrainRouted`` holds every route to its replicas)."""
    monkeypatch.setenv(ENV, env)
    replicas = _replicas(backend)
    assert default_train_route("cuda", replicas) == env
    with pytest.raises(ValueError, match=match):
        TrainRouted(types.SimpleNamespace(replicas=replicas, device=torch.device("cuda")),
                    default_train_route("cuda", replicas))


@pytest.mark.parametrize("route,backend,match", [
    ("graph", "gloo", "gloo replicas"), ("compile", "gloo", "compile"),
    ("compile", "nccl", "compile"),
])
@pytest.mark.parametrize("local_bn", [False, True])
def test_asking_for_a_route_the_replicas_cannot_take_raises(route, backend, match, local_bn):
    model, tx = _cpu_step_parts()
    replicas = _replicas(backend)
    with pytest.raises(ValueError, match=match):
        if local_bn:
            make_local_bn_train_step(model, tx, 0.1, replicas, route=route)
        else:
            from mnasnet_tpu_torch.models.layers import set_replicas

            set_replicas(model, replicas)
            make_train_step(model, tx, 0.1, replicas=replicas, route=route)


def test_the_ranks_read_the_backend_from_the_group(runs):
    for rank in runs["ranks"]:
        assert rank["backend"] == ("gloo", "gloo")
        assert all(rank[name]["route"] == "eager" for name in W.SCENARIOS)


# ---------------------------------------------- the device part of a step


@pytest.mark.parametrize("name", list(W.SCENARIOS))
def test_the_device_step_reads_nothing_on_the_host_after_the_warm_up(runs, name):
    for rank in runs["ranks"]:
        assert rank[name]["error"] is None, rank[name]["error"]
        assert rank[name]["steps"] == 2


@pytest.mark.parametrize("name", list(W.SCENARIOS))
def test_each_step_issues_the_predicted_collectives(runs, name):
    """The second step issues exactly ``step_collectives``; the first adds
    one check of each new BN plane size (sync-BN only)."""
    trainer_kw, model_kw = W.SCENARIOS[name]
    kw = dict(model_kw)
    model = P._model(None, kw.pop("dropout", 0.0), kw.pop("stats", "two_pass"), **kw)
    sync_bn = trainer_kw.get("sync_bn", True)
    predicted = step_collectives(model, sync_bn=sync_bn,
                                 grad_accum=trainer_kw.get("grad_accum", 1))
    planes = len({(P.STEP_IMAGE // s) ** 2 for s in (2, 4, 8, 16, 32)}) if sync_bn else 0
    for rank in runs["ranks"]:
        assert rank[name]["predicted"] == predicted
        assert rank[name]["collectives"] == [predicted + planes, predicted]


def test_the_host_read_guard_catches_a_read():
    with pytest.raises(W.HostRead):
        with W.no_host_reads():
            torch.ones(2).sum().item()
    assert torch.ones(2).sum().item() == 2.0


# ------------------------------------------------------ the capture guard


@pytest.fixture
def gloo_world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield Replicas(0, 1, "cpu")
    finally:
        dist.destroy_process_group()


def test_global_rows_raises_for_a_new_plane_size_inside_a_capture(gloo_world1, monkeypatch):
    replicas = gloo_world1
    assert global_rows(64, replicas) == 64 and replicas.collectives == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert global_rows(64, replicas) == 64  # seen at the warm-up: no read
    with pytest.raises(RuntimeError, match="25 rows per channel"):
        global_rows(25, replicas)
    assert replicas.collectives == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert global_rows(25, replicas) == 25 and replicas.collectives == 2


class _Graph:
    """Stands for a ``torch.cuda.CUDAGraph``: records its ``reset``."""

    def __init__(self, log):
        self.log = log

    def reset(self):
        self.log.append(("reset", dist.is_initialized()))


def test_close_resets_every_registered_graph_before_leaving_the_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    replicas = Replicas(0, 1, "cpu")
    log = []
    held = _Graph(log)  # held by the caller, as an exception's traceback holds one
    cycle = _Graph(log)
    cycle.me = cycle  # in a reference cycle no collection has freed yet
    replicas.add_graph(held)
    replicas.add_graph(cycle)
    replicas.add_graph(_Graph(log))  # freed at once: nothing to reset
    del cycle
    assert replicas.backend == "gloo"
    close(replicas)
    assert log == [("reset", True), ("reset", True)] and not dist.is_initialized()


# ------------------------------------------------------------------ parity


def test_the_routed_sync_bn_step_matches_jax(runs):
    ref, moved = runs["jax"]
    ours = runs["ranks"][0]["sync"]
    for rank in runs["ranks"][1:]:
        assert rank["sync"]["loss"] == ours["loss"]
        for field in ("params", "stats"):
            for n in ours[field]:
                assert torch.equal(rank["sync"][field][n], ours[field][n]), (field, n)
    _close_to_jax(ours["loss"], ref["loss"], moved["loss"], "loss")
    for field in ("params", "stats"):
        assert ours[field].keys() == ref[field].keys()
        for n in ref[field]:
            _close_to_jax(ours[field][n].numpy(), ref[field][n], moved[field][n], f"{field} {n}")
