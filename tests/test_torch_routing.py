"""Per-batch routing (``mnasnet_tpu_torch/utils/routing.py``) and the
compilation cache (``utils/compilation_cache.py``) on the CPU: the
counterparts of tests/test_xla_options.py and the reference's cache flag.

The table lookup, the CPU default, the environment override and the
dispatch with an injected ``route_for`` are the reference's cases. The
compile route runs Dynamo with the ``aot_eager`` backend (no code
generation) and checks that the port's kernel ops stay opaque in the graph,
that ten batch sizes each stay compiled, and that a compile past Dynamo's
recompile limit raises instead of falling back to eager. The graph route
needs a card (``tests/test_torch_gpu.py``).
"""

import os

import numpy as np
import pytest
import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.train.steps import make_eval_step, make_predict_fn
from mnasnet_tpu_torch.utils import compilation_cache
from mnasnet_tpu_torch.utils.routing import (
    ROUTES,
    SERVE_ROUTE_BATCH_RANGES,
    BatchRouted,
    default_route,
    route_for_batch,
)

ENV = "MNASNET_TPU_TORCH_ROUTE"
KERNEL_OPS = ("mnasnet_tpu_torch.dw_conv_bn_act", "mnasnet_tpu_torch.mbconv_block")


@pytest.fixture(autouse=True)
def _no_route_override(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)


@pytest.fixture(autouse=True)
def _fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _model(seed=0):
    return create_model("mnasnet0_35", device="cpu", num_classes=8, dw_impl="kernel",
                        seed=seed).requires_grad_(False)


def _images(b, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32))


class RecordingBackend:
    """A Dynamo backend that records each graph it is given, counts the
    kernel-op nodes in it, and counts the calls that run the compiled graph."""

    def __init__(self):
        self.graphs = []
        self.runs = 0

    def __call__(self, gm, example_inputs):
        self.graphs.append(gm)

        def run(*args):
            self.runs += 1
            return gm.forward(*args)

        return run

    def op_nodes(self, i=-1):
        targets = [str(n.target) for n in self.graphs[i].graph.nodes if n.op == "call_function"]
        return {op: sum(op in t for t in targets) for op in KERNEL_OPS}


def test_table_covers_every_batch_size_with_a_known_route():
    lo0 = SERVE_ROUTE_BATCH_RANGES[0][0]
    assert lo0 == 1
    for (_, hi, _), (lo, _, _) in zip(SERVE_ROUTE_BATCH_RANGES, SERVE_ROUTE_BATCH_RANGES[1:]):
        assert lo == hi + 1
    assert SERVE_ROUTE_BATCH_RANGES[-1][1] >= 1 << 20
    assert all(route in ROUTES for _, _, route in SERVE_ROUTE_BATCH_RANGES)


@pytest.mark.parametrize("i", range(len(SERVE_ROUTE_BATCH_RANGES)))
def test_table_lookup_at_every_boundary(i):
    lo, hi, route = SERVE_ROUTE_BATCH_RANGES[i]
    assert route_for_batch(lo) == route
    assert route_for_batch(hi) == route
    if i:
        assert route_for_batch(lo - 1) == SERVE_ROUTE_BATCH_RANGES[i - 1][2]


def test_table_refuses_a_batch_of_zero():
    with pytest.raises(ValueError, match="no route"):
        route_for_batch(0)


@pytest.mark.parametrize("bs", [1, 8, 32, 128, 512])
def test_cpu_device_gets_eager(bs):
    assert default_route(bs, "cpu") == "eager"
    assert default_route(bs, torch.device("cpu")) == "eager"


@pytest.mark.parametrize("bs", [1, 8, 32, 128])
def test_cuda_device_reads_the_table(bs):
    assert default_route(bs, "cuda") == route_for_batch(bs)


@pytest.mark.parametrize("val", ["none", "off", "", "0", "NONE"])
def test_env_disable_gives_eager_everywhere(monkeypatch, val):
    monkeypatch.setenv(ENV, val)
    for bs in (1, 8, 128):
        assert default_route(bs, "cuda") == "eager"
        assert default_route(bs, "cpu") == "eager"


@pytest.mark.parametrize("route", ROUTES)
def test_env_route_wins_for_every_size_and_device(monkeypatch, route):
    monkeypatch.setenv(ENV, route.upper())
    for bs in (1, 8, 128):
        assert default_route(bs, "cuda") == route
        assert default_route(bs, "cpu") == route


def test_env_bad_route_raises(monkeypatch):
    monkeypatch.setenv(ENV, "jit")
    with pytest.raises(ValueError, match="expected one of"):
        default_route(8, "cuda")


def test_dispatch_with_a_recording_route_for():
    """The route is resolved from the batch argument's leading dim on every
    call; one callable per (route, shapes)."""
    seen = []

    def route_for(bs):
        seen.append(bs)
        return "eager"

    routed = BatchRouted(lambda s, x: x * s, batch_arg=1, route_for=route_for)
    out = routed(torch.tensor(2.0), torch.ones(4, 3))
    assert out.shape == (4, 3) and float(out[0, 0]) == 2.0
    routed(torch.tensor(2.0), torch.ones(7, 3))
    routed(torch.tensor(3.0), np.ones((7, 3), np.float32))
    assert seen == [4, 7, 7]
    assert len(routed._cache) == 2 and sorted(routed.calls.values()) == [1, 2]
    assert all(key[0] == "eager" for key in routed.calls)


def test_default_route_for_is_eager_on_the_cpu():
    routed = BatchRouted(lambda x: x + 1)
    routed(torch.zeros(3, 2))
    assert [key[0] for key in routed.calls] == ["eager"]


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="unknown route"):
        BatchRouted(lambda x: x, route_for=lambda bs: "jit")(torch.zeros(2))


def test_graph_route_refuses_the_cpu():
    """No capture is possible off the card, and nothing falls back to eager."""
    routed = BatchRouted(lambda x: x + 1, route_for=lambda bs: "graph")
    with pytest.raises(ValueError, match="CUDA device"):
        routed(torch.zeros(2, 2))
    assert not routed.replays


def test_compile_of_the_model_keeps_the_ops_opaque():
    """torch.compile(fullgraph=True) of the eval forward: no graph break, the
    graph holds 1 dw and 16 MBConv op nodes, the output equals eager's."""
    model = _model()
    x = _images(3).permute(0, 3, 1, 2)
    backend = RecordingBackend()
    with torch.no_grad():
        want = model(x)
        got = torch.compile(model, backend=backend, fullgraph=True)(x)
    assert len(backend.graphs) == 1 and backend.runs == 1
    assert backend.op_nodes() == dict(zip(KERNEL_OPS, (1, 16)))
    assert torch.equal(got, want)


def test_compile_route_of_the_eval_step_equals_eager():
    model = _model()
    step = make_eval_step(model)
    x, y = _images(4), torch.tensor([1, 2, -1, 3])
    want = step(x, y)
    backend = RecordingBackend()
    routed = BatchRouted(step, route_for=lambda bs: "compile", backend=backend)
    for _ in range(2):
        got = routed(x, y)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert len(backend.graphs) == 1 and backend.runs == 2
    assert backend.op_nodes() == dict(zip(KERNEL_OPS, (1, 16)))


def test_compile_route_keeps_ten_batch_sizes_compiled():
    """One compile per batch size, each on a code object of its own: ten
    sizes (past Dynamo's default limit of 8 recompiles of one code object)
    stay compiled, and every call runs a compiled graph."""
    model = _model()
    predict = make_predict_fn(model)
    backend = RecordingBackend()
    routed = BatchRouted(predict, route_for=lambda bs: "compile", backend=backend)
    sizes = range(1, 11)
    for _ in range(2):
        for b in sizes:
            x = _images(b, seed=b)
            assert torch.equal(routed(x), predict(x))
    assert len(backend.graphs) == len(sizes)
    assert backend.runs == 2 * len(sizes)
    assert all(backend.op_nodes(i) == dict(zip(KERNEL_OPS, (1, 16)))
               for i in range(len(sizes)))


_SCALE = [1.0]


def _reads_a_global(x):
    return x * _SCALE[0]


def test_compile_route_past_the_recompile_limit_raises(monkeypatch):
    """A callable whose guards fail on every call recompiles on one key; at
    Dynamo's limit the compile route raises, it never runs eager silently."""
    monkeypatch.setattr(torch._dynamo.config, "recompile_limit", 2)
    monkeypatch.setattr(torch._dynamo.config, "fail_on_recompile_limit_hit", False)
    routed = BatchRouted(_reads_a_global, route_for=lambda bs: "compile", backend="eager")
    x = torch.ones(2)
    with pytest.raises(Exception, match="recompile_limit|fail_on_recompile_limit_hit"):
        for i in range(5):
            _SCALE[0] = float(i + 2)
            assert torch.equal(routed(x), x * _SCALE[0])
    assert torch._dynamo.config.fail_on_recompile_limit_hit


# --------------------------------------------------------------- cache


@pytest.fixture
def cache_env(monkeypatch):
    for var in ("MNASNET_TPU_COMPILATION_CACHE", "TORCHINDUCTOR_CACHE_DIR",
                "TRITON_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    yield
    compilation_cache.disable_compilation_cache()


def test_cache_flag_wins_over_env(cache_env, tmp_path, monkeypatch):
    monkeypatch.setenv("MNASNET_TPU_COMPILATION_CACHE", str(tmp_path / "env"))
    got = compilation_cache.enable_compilation_cache(str(tmp_path / "flag"))
    assert got == str(tmp_path / "flag") and os.path.isdir(got)
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == got
    assert os.environ["TRITON_CACHE_DIR"] == os.path.join(got, "triton")
    assert not (tmp_path / "env").exists()


def test_cache_env_when_no_flag(cache_env, tmp_path, monkeypatch):
    monkeypatch.setenv("MNASNET_TPU_COMPILATION_CACHE", str(tmp_path / "env"))
    assert compilation_cache.enable_compilation_cache() == str(tmp_path / "env")
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "env")


def test_cache_off_without_flag_or_env(cache_env):
    assert compilation_cache.enable_compilation_cache() is None
    assert "TORCHINDUCTOR_CACHE_DIR" not in os.environ


@pytest.mark.parametrize("val", ["none", "off", "0", "", "OFF"])
def test_cache_disabled_spellings(cache_env, tmp_path, monkeypatch, val):
    monkeypatch.chdir(tmp_path)
    assert compilation_cache.enable_compilation_cache(val) is None
    monkeypatch.setenv("MNASNET_TPU_COMPILATION_CACHE", val)
    assert compilation_cache.enable_compilation_cache() is None
    assert os.listdir(tmp_path) == [] and "TORCHINDUCTOR_CACHE_DIR" not in os.environ


def test_cache_disable_restores_the_variables(cache_env, tmp_path, monkeypatch):
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "mine"))
    compilation_cache.enable_compilation_cache(str(tmp_path / "c"))
    compilation_cache.disable_compilation_cache()
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "mine")
    assert "TORCHINDUCTOR_CACHE_DIR" not in os.environ


def test_cache_entries_land_under_the_directory(cache_env, tmp_path):
    """One tiny Inductor compile on the CPU writes its FX-graph cache entry
    under the directory."""
    path = compilation_cache.enable_compilation_cache(str(tmp_path / "cache"))
    f = torch.compile(lambda x: torch.relu(x) * 2 + 1, dynamic=False)
    x = torch.randn(16)
    assert torch.equal(f(x), torch.relu(x) * 2 + 1)
    entries = [os.path.join(d, n) for d, _, names in os.walk(path) for n in names]
    assert any(os.sep + "fxgraph" + os.sep in e for e in entries), entries

