"""The port's serving deployment on the CPU: the ``torch.export`` artifact
(``mnasnet_tpu_torch/tools/export_serving.py``), ``load_serving``
(``mnasnet_tpu_torch/serving.py``) and ``export_torch``, against the port's
live forward and the JAX package: the counterparts of
tests/test_export_serving.py.

Weights come from a seeded JAX ``MNASNet.init`` with non-trivial BN
statistics and affine (numpy), go to the port through the converter, and the
same numpy images go through the JAX forward and the artifact. mnasnet0_35 at
32 px, fp32, 8 classes, traced with ``dw_impl="kernel"``: on the CPU the
kernel ops run their plain versions. Tolerances: the artifact against the
live forward of the same module, bit for bit (the same ops in the same
order); against JAX, 1e-4 as tests/test_torch_model.py holds the port's
forward (fp32 convolutions and sums in another order); ``--raw-input``
against the host normalize, atol 1e-5 as tests/test_export_serving.py.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mnasnet_tpu.convert.torch_converter import flax_to_torch
from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.convert.torch_converter import state_dict_from_jax
from mnasnet_tpu_torch.data.transforms import normalize
from mnasnet_tpu_torch.serving import load_serving
from mnasnet_tpu_torch.tools import export_serving, export_torch
from mnasnet_tpu_torch.train.checkpoint import CheckpointManager
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_model import _perturb_bn  # noqa: E402
from torch_ref import TorchMNASNet  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
IMG, CLASSES, ALPHA = 32, 8, 0.35
KERNEL_OPS = ("mnasnet_tpu_torch.dw_conv_bn_act", "mnasnet_tpu_torch.mbconv_block")


def _jax_variables(seed):
    """Seeded JAX variables (numpy) with BN statistics and affine perturbed."""
    rng = np.random.default_rng(seed)
    variables = JaxMNASNet(alpha=ALPHA, num_classes=CLASSES).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 3)), train=False)
    variables = jax.tree.map(lambda a: np.array(a), variables)
    _perturb_bn(variables["params"], rng)
    _perturb_bn(variables["batch_stats"], rng)
    return variables


def _forward(weights, batch_size=4, **kw):
    return export_serving.build_forward("mnasnet0_35", CLASSES, "float32", weights, IMG,
                                        batch_size, device="cpu", **kw)


def _images(b, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, IMG, IMG, 3)).astype(np.float32))


def _live(fn, x):
    with torch.no_grad():
        return fn(x)


def _program(data):
    return torch.export.load(io.BytesIO(data))


@pytest.fixture(scope="module")
def case():
    """The JAX variables, the port's forward with them, and its fixed-batch
    (4) and symbolic-batch artifacts."""
    variables = _jax_variables(0)
    fn, x = _forward(state_dict_from_jax(variables, ALPHA))
    return {"variables": variables, "fn": fn,
            "fixed": export_serving.export_artifact(fn, x),
            "symbolic": export_serving.export_artifact(fn, x, symbolic_batch=True)}


@pytest.mark.parametrize("kind", ["fixed", "symbolic"])
def test_artifact_holds_one_dw_and_sixteen_mbconv_ops(case, kind):
    targets = [str(n.target) for n in _program(case[kind]).graph.nodes
               if n.op == "call_function"]
    assert [sum(op in t for t in targets) for op in KERNEL_OPS] == [1, 16]


def test_torch_route_artifact_holds_no_kernel_op():
    fn, x = _forward(None, dw_impl="torch")
    targets = [str(n.target) for n in _program(export_serving.export_artifact(fn, x)).graph.nodes]
    assert not any(op in t for t in targets for op in KERNEL_OPS)


def test_artifact_equals_live_forward_at_a_fixed_batch(case):
    x = _images(4)
    got = _program(case["fixed"]).module()(x)
    assert got.shape == (4, CLASSES) and got.dtype == torch.float32
    assert torch.equal(got, _live(case["fn"], x))


@pytest.mark.parametrize("b", [1, 3, 16])
def test_symbolic_batch_serves_any_batch_size(case, b):
    x = _images(b, seed=b)
    got = _program(case["symbolic"]).module()(x)
    assert got.shape == (b, CLASSES)
    assert torch.equal(got, _live(case["fn"], x))


def test_fixed_batch_artifact_rejects_another_batch(case):
    with pytest.raises((AssertionError, RuntimeError, ValueError), match="size"):
        _program(case["fixed"]).module()(_images(3))


def test_export_bakes_the_weights_in():
    """Two weight sets give two artifacts that disagree: the weights ride
    inside the artifact."""
    x = _images(2)
    outs = []
    for seed in (1, 2):
        fn, ex = _forward(state_dict_from_jax(_jax_variables(seed), ALPHA), batch_size=2)
        outs.append(_program(export_serving.export_artifact(fn, ex)).module()(x))
    assert not torch.equal(outs[0], outs[1])


def test_raw_input_artifact_matches_host_normalize(case):
    """--raw-input: uint8 in, /255 and mean/std in fp32 inside the artifact,
    against the host's ``transforms.normalize`` feeding the float artifact."""
    sd = state_dict_from_jax(case["variables"], ALPHA)
    fn, x = _forward(sd, batch_size=2, raw_input=True)
    assert x.dtype == torch.uint8
    raw = _program(export_serving.export_artifact(fn, x)).module()
    u8 = np.random.default_rng(0).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    host = np.stack([normalize(im.astype(np.float32) / 255.0) for im in u8])
    want = _live(case["fn"], torch.from_numpy(host))
    np.testing.assert_allclose(raw(torch.from_numpy(u8)).numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("source", ["path", "bytes", "program"])
def test_load_serving_matches_live_forward(case, tmp_path, source):
    path = tmp_path / "m.pt2"
    path.write_bytes(case["symbolic"])
    artifact = {"path": str(path), "bytes": case["symbolic"],
                "program": _program(case["symbolic"])}[source]
    predict = load_serving(artifact, device="cpu")
    for b in (1, 4):
        x = _images(b, seed=10 + b)
        assert torch.equal(predict(x), _live(case["fn"], x))
        assert torch.equal(predict(x.numpy()), _live(case["fn"], x))
    assert {key[0] for key in predict.calls} == {"eager"}


def test_load_serving_refuses_a_missing_card_and_an_unknown_route(case):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving(case["symbolic"])
    with pytest.raises(ValueError, match="unknown route"):
        load_serving(case["symbolic"], route="jit", device="cpu")


_CHILD = """
import sys
import torch
from mnasnet_tpu_torch.serving import load_serving
torch.set_num_threads(int(sys.argv[4]))
predict = load_serving(sys.argv[1], device="cpu")
torch.save(predict(torch.load(sys.argv[2])), sys.argv[3])
"""


def test_fresh_process_loads_the_artifact(case, tmp_path):
    """A new interpreter that imports only mnasnet_tpu_torch.serving loads the
    artifact (the op registrations come with it) and reproduces the logits."""
    art, inp, out = tmp_path / "m.pt2", tmp_path / "x.pt", tmp_path / "y.pt"
    art.write_bytes(case["symbolic"])
    x = _images(3, seed=5)
    torch.save(x, inp)
    r = subprocess.run([sys.executable, "-c", _CHILD, str(art), str(inp), str(out),
                        str(torch.get_num_threads())], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert torch.equal(torch.load(out), _program(case["symbolic"]).module()(x))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_artifact_matches_the_jax_forward(case, impl):
    """The artifact's logits against ``MNASNet.apply`` on the same weights, the
    JAX side at ``precision="highest"``; Pallas in interpret mode on the CPU,
    as the JAX package's tests run it."""
    x = np.random.default_rng(3).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    jv = jax.tree.map(jnp.asarray, case["variables"])
    want = np.asarray(JaxMNASNet(alpha=ALPHA, num_classes=CLASSES, dw_impl=impl,
                                 precision="highest").apply(jv, jnp.asarray(x), train=False))
    got = load_serving(case["symbolic"], device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_export_serving_cli_exports_and_verifies(case, tmp_path, capsys):
    npz = tmp_path / "w.npz"
    np.savez(npz, **flax_to_torch(case["variables"], ALPHA))
    art = tmp_path / "m.pt2"
    common = ["--arch", "mnasnet0_35", "--num-classes", str(CLASSES), "--image-size", str(IMG),
              "--dtype", "float32", "--device", "cpu", "--pretrained", str(npz), "-b", "3"]
    assert export_serving.main([*common, "--symbolic-batch", "--out", str(art)]) == 0
    assert "call: f(float32[b,32,32,3])" in capsys.readouterr().out
    assert export_serving.main([*common, "--verify", str(art)]) == 0
    assert "verify OK" in capsys.readouterr().out
    x = _images(3, seed=7)
    assert torch.equal(load_serving(str(art), device="cpu")(x), _live(case["fn"], x))


def test_export_serving_cli_needs_a_weight_source(tmp_path):
    with pytest.raises(SystemExit, match="need --resume, --pretrained, or --random-init"):
        export_serving.main(["--device", "cpu", "--out", str(tmp_path / "m.pt2")])


# ------------------------------------------------------------ export_torch


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory with two checkpoints of the port: epoch 0 (the JAX
    weights, best) and epoch 1 (the same weights shifted), with a model-EMA
    shadow that holds the epoch-0 parameters."""
    variables = _jax_variables(0)
    model = create_model("mnasnet0_35", device="cpu", num_classes=CLASSES)
    model.load_state_dict(state_dict_from_jax(variables, ALPHA), strict=True)
    tx = create_optimizer("sgd", 0.1, model_ema=0.5)
    state = TrainState.create(model, tx)
    out = tmp_path_factory.mktemp("run")
    mgr = CheckpointManager(str(out))
    mgr.save(0, model, tx, state, 50.0, 50.0, is_best=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.25)
    mgr.save(1, model, tx, state, 25.0, 50.0)
    return out, variables


@pytest.mark.parametrize("flags,shift", [([], 0.25), (["--best"], 0.0), (["--use-ema"], 0.0)])
def test_export_torch_writes_a_torchvision_state_dict(run_dir, tmp_path, capsys, flags, shift):
    """The .pth loads strict into the port's model and into torchvision's
    module tree, and equals the JAX converter's ``flax_to_torch`` of the same
    weights (the latest checkpoint's parameters are those shifted by 0.25)."""
    out, variables = run_dir
    pth = tmp_path / "m.pth"
    assert export_torch.main(["--resume", str(out), "--arch", "mnasnet0_35", "--out", str(pth),
                              *flags]) == 0
    assert f"wrote {pth}" in capsys.readouterr().out
    payload = torch.load(pth, weights_only=True)
    assert payload["arch"] == "mnasnet0_35"
    sd = payload["state_dict"]
    want = flax_to_torch(variables, ALPHA)
    params = dict(create_model("mnasnet0_35", device="cpu", num_classes=CLASSES)
                  .named_parameters())
    assert sd.keys() == want.keys()
    for k, v in want.items():
        expect = torch.from_numpy(np.array(v)) + (shift if k in params else 0)
        assert torch.equal(sd[k], expect.to(sd[k].dtype)), k
    create_model("mnasnet0_35", device="cpu", num_classes=CLASSES).load_state_dict(sd, strict=True)
    TorchMNASNet(ALPHA, num_classes=CLASSES).load_state_dict(sd, strict=True)
