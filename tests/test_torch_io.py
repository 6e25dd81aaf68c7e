"""Weight IO, transforms, loss, the CLI and package boundaries of the PyTorch
port, against the JAX package where it has a counterpart."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from PIL import Image

from mnasnet_tpu.convert import torch_converter as jax_conv
from mnasnet_tpu.data.transforms import eval_transform as jax_eval_transform
from mnasnet_tpu.train.loss import cross_entropy as jax_cross_entropy
from mnasnet_tpu.train.loss import topk_correct as jax_topk_correct
from mnasnet_tpu_torch import create_model, load_pretrained
from mnasnet_tpu_torch.convert import torch_converter as conv
from mnasnet_tpu_torch.data.transforms import eval_transform
from mnasnet_tpu_torch.ops.cuda.dw_conv import dw_conv_bn_act, dw_conv_reference
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fused, mbconv_reference
from mnasnet_tpu_torch.ops.depthwise import depthwise_conv_bn_relu_fused
from mnasnet_tpu_torch.pretrained import load_state_dict_file
from mnasnet_tpu_torch.train.loss import cross_entropy, topk_correct

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "transforms_golden.npz"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _random_state_dict(alpha=0.35, num_classes=1000, seed=0):
    sd = create_model(f"mnasnet{str(alpha).replace('.', '_')}", device="cpu",
                      num_classes=num_classes, seed=seed).state_dict()
    g = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if k.endswith(("running_mean", "bias")):
            v.copy_(torch.randn(v.shape, generator=g) * 0.1)
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    return sd


def test_converter_matches_jax_both_ways():
    sd = _random_state_dict(0.5)
    ours = conv.torch_to_flax(sd, 0.5)
    ref = jax_conv.torch_to_flax(sd, 0.5)
    a, b = dict(_flat(ours)), dict(_flat(ref))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    back, back_ref = conv.flax_to_torch(ours, 0.5), jax_conv.flax_to_torch(ref, 0.5)
    assert back.keys() == back_ref.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], back_ref[k])
        np.testing.assert_array_equal(back[k], sd[k].numpy())
    model = create_model("mnasnet0_5", device="cpu")
    model.load_state_dict(conv.state_dict_from_jax(ours, 0.5), strict=True)


def test_converter_rejects_v1_and_wrong_alpha():
    sd = _random_state_dict(0.35)
    with pytest.raises(ValueError, match="v1"):
        conv.torch_to_flax({**sd, "_version": 1}, 0.35)
    with pytest.raises(ValueError, match="depth multiplier"):
        conv.torch_to_flax(sd, 1.0)


@pytest.mark.parametrize("fmt", [".pth", ".pth.tar", ".npz"])
def test_load_pretrained_formats_and_module_prefix(tmp_path, fmt):
    sd = _random_state_dict(0.35)
    path = str(tmp_path / f"w{fmt}")
    if fmt == ".npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    elif fmt == ".pth.tar":
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    else:
        torch.save(sd, path)
    loaded = load_state_dict_file(path)
    assert loaded.keys() == sd.keys()
    model = load_pretrained("mnasnet0_35", path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_load_pretrained_without_counters(tmp_path):
    """Converted arrays may lack num_batches_tracked; eval does not read it."""
    sd = {k: v.numpy() for k, v in _random_state_dict(0.35).items()
          if not k.endswith("num_batches_tracked")}
    np.savez(tmp_path / "w.npz", **sd)
    model = load_pretrained("mnasnet0_35", str(tmp_path / "w.npz"), device="cpu")
    assert torch.equal(model.state_dict()["layers.1.running_var"],
                       torch.from_numpy(sd["layers.1.running_var"]))


def test_load_pretrained_rejects(tmp_path):
    sd = _random_state_dict(0.35)
    torch.save({**sd, "_version": 1}, tmp_path / "v1.pth")
    with pytest.raises(ValueError, match="v1"):
        load_pretrained("mnasnet0_35", str(tmp_path / "v1.pth"), device="cpu")
    torch.save(sd, tmp_path / "w.pth")
    with pytest.raises(ValueError, match="depth multiplier"):
        load_pretrained("mnasnet1_0", str(tmp_path / "w.pth"), device="cpu")
    with pytest.raises(ValueError, match="unknown arch"):
        load_pretrained("mnasnet0_9", str(tmp_path / "w.pth"), device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        load_state_dict_file(str(tmp_path / "w.ckpt"))


def test_load_pretrained_swaps_head(tmp_path):
    sd = _random_state_dict(0.35)
    torch.save(sd, tmp_path / "w.pth")
    model = load_pretrained("mnasnet0_35", str(tmp_path / "w.pth"), device="cpu",
                            num_classes=10, seed=5)
    own = model.state_dict()
    fresh = create_model("mnasnet0_35", device="cpu", num_classes=10, seed=5).state_dict()
    assert own["classifier.1.weight"].shape == (10, 1280)
    assert torch.equal(own["classifier.1.weight"], fresh["classifier.1.weight"])
    assert all(torch.equal(own[k], sd[k]) for k in sd if not k.startswith("classifier"))


def test_eval_transform_matches_jax():
    rng = np.random.default_rng(0)
    for h, w in [(300, 400), (500, 240), (100, 90), (256, 256)]:
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        for size in (224, 64):
            out = eval_transform(img, size)
            assert out.dtype == np.float32 and out.shape == (size, size, 3)
            np.testing.assert_array_equal(out, jax_eval_transform(img, size))
    gray = Image.fromarray(rng.integers(0, 256, (80, 120), dtype=np.uint8))
    np.testing.assert_array_equal(eval_transform(gray, 64), jax_eval_transform(gray, 64))


def test_eval_transform_golden():
    with np.load(GOLDEN) as z:
        img = Image.fromarray(z["image"])
        np.testing.assert_allclose(eval_transform(img, 224), z["eval_224"], atol=1e-6)
        np.testing.assert_allclose(eval_transform(img, 160), z["eval_160"], atol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_topk_match_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    labels = np.array([1, 4, -1, 9, 0, -1], dtype=np.int32)
    ours = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    for ncls in (10, 4):  # 4 classes: top-5 clamps to top-4
        lg, lb = logits[:, :ncls], np.where(labels < ncls, labels, 0).astype(np.int32)
        ours_k = topk_correct(torch.from_numpy(lg), torch.from_numpy(lb))
        ref_k = jax_topk_correct(jnp.asarray(lg), jnp.asarray(lb))
        assert {k: int(v) for k, v in ours_k.items()} == {k: int(v) for k, v in ref_k.items()}
        assert int(ours_k["count"]) == 4
    all_pad = torch.full((2,), -1)
    assert float(cross_entropy(torch.zeros(2, 3), all_pad)) == 0.0


def _run(args, cwd=REPO, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_eval_cli_image(tmp_path):
    torch.save(_random_state_dict(0.35), tmp_path / "w.pth")
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (90, 120, 3), dtype=np.uint8)
                    ).save(tmp_path / "img.png")
    r = _run(["-m", "mnasnet_tpu_torch.eval", "--image", str(tmp_path / "img.png"),
              "--arch", "mnasnet0_35", "--pretrained", str(tmp_path / "w.pth"),
              "--image-size", "64", "--topk", "3", "--device", "cpu",
              "--dtype", "bfloat16", "--fused-kernels", "kernel"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 3 and all(line.startswith("class ") for line in lines)
    probs = [float(line.split(": ")[1]) for line in lines]
    assert probs == sorted(probs, reverse=True)
    r = _run(["-m", "mnasnet_tpu_torch.eval", str(tmp_path), "--device", "cpu"])
    assert r.returncode != 0 and "need --pretrained or --resume" in r.stderr


def test_package_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'mnasnet_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mnasnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mnasnet_tpu_torch.__path__,\n"
        "                                               'mnasnet_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'mnasnet_tpu')]\n"
        "print(len(names), bad)\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    count, bad = r.stdout.strip().split(" ", 1)
    assert int(count) >= 15 and bad == "[]"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["chip_smoke.py"], timeout=120)
    assert r.returncode != 0
    last = r.stdout.strip().splitlines()[-1:] or [""]
    assert '"ok": true' not in last[0]


def test_cpu_tensors_take_the_plain_versions():
    """On a CPU tensor the kernel wrappers run their plain versions and count
    no launch, even when the kernel route is asked for."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 1, 16)).astype(np.float32))
    s, b = torch.ones(16), torch.zeros(16)
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    assert all(isinstance(n, int) for n in before)
    y = depthwise_conv_bn_relu_fused(x, w, s, b, stride=2, impl="kernel")
    assert torch.equal(y, dw_conv_reference(x, w, s, b, stride=2))
    we = torch.from_numpy(rng.standard_normal((16, 48)).astype(np.float32))
    wd = torch.from_numpy(rng.standard_normal((3, 3, 1, 48)).astype(np.float32))
    wp = torch.from_numpy(rng.standard_normal((48, 16)).astype(np.float32))
    args = (x, we, torch.ones(48), torch.zeros(48), wd, torch.ones(48), torch.zeros(48),
            wp, torch.ones(16), torch.zeros(16))
    kw = dict(kernel_size=3, stride=1, residual=True)
    assert torch.equal(mbconv_fused(*args, **kw), mbconv_reference(*args, **kw))
    assert (dw_conv_bn_act.launches, mbconv_fused.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError, match="stride"):
        dw_conv_bn_act(x, torch.zeros(3, 3, 1, 16), torch.ones(16), torch.zeros(16), stride=3)
    with pytest.raises(ValueError, match="kernel size"):
        dw_conv_bn_act(x, torch.zeros(7, 7, 1, 16), torch.ones(16), torch.zeros(16))
    with pytest.raises(ValueError, match="scale"):
        dw_conv_bn_act(x, torch.zeros(3, 3, 1, 16), torch.ones(8), torch.zeros(16))
    with pytest.raises(ValueError, match="residual"):
        mbconv_fused(x, torch.zeros(16, 48), torch.ones(48), torch.zeros(48),
                     torch.zeros(3, 3, 1, 48), torch.ones(48), torch.zeros(48),
                     torch.zeros(48, 16), torch.ones(16), torch.zeros(16),
                     kernel_size=3, stride=2, residual=True)
    with pytest.raises(ValueError, match="pads"):
        depthwise_conv_bn_relu_fused(x, torch.zeros(3, 3, 1, 16), torch.ones(16),
                                     torch.zeros(16), padding=0, impl="kernel")

