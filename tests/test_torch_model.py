"""The PyTorch port's eval-mode model against the JAX package and the torch
module tree of tests/torch_ref.py.

Weights come from a seeded JAX ``MNASNet.init`` (BN statistics and affine
made non-trivial with numpy) and go to both packages; the same numpy images
go through ``MNASNet.apply`` and the port's forward. The JAX forwards run once
per module (the Pallas route in interpret mode takes tens of seconds).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.models.mnasnet import count_macs as jax_count_macs
from mnasnet_tpu_torch import MODEL_REGISTRY, MNASNet, create_model
from mnasnet_tpu_torch.convert.torch_converter import state_dict_from_jax
from mnasnet_tpu_torch.models.mnasnet import count_macs
from mnasnet_tpu_torch.train.steps import make_eval_step, make_predict_fn

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ref import EXPECTED_PARAMS, TorchMNASNet, randomize_bn_stats  # noqa: E402

ALPHAS = (0.35, 0.5, 0.75, 1.0, 1.3, 1.4)


def _arch(alpha):
    return f"mnasnet{str(alpha).replace('.', '_')}"


def _perturb_bn(tree, rng):
    """Non-trivial BN statistics and affine, in place (numpy leaves)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            if set(val) == {"mean", "var"}:
                val["mean"] = (rng.standard_normal(val["mean"].shape) * 0.1).astype(np.float32)
                val["var"] = rng.uniform(0.5, 2.5, val["var"].shape).astype(np.float32)
            elif set(val) == {"scale", "bias"} and val["scale"].ndim == 1:
                val["scale"] = rng.uniform(0.5, 1.5, val["scale"].shape).astype(np.float32)
                val["bias"] = (rng.standard_normal(val["bias"].shape) * 0.1).astype(np.float32)
            else:
                _perturb_bn(val, rng)


@pytest.fixture(scope="module")
def jax_case():
    """Seeded JAX weights (numpy), images, and the JAX logits at alpha=0.35,
    64 px, fp32 on the "xla" and "pallas" routes."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = JaxMNASNet(alpha=0.35, num_classes=8).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = jax.tree.map(lambda a: np.array(a), variables)
    _perturb_bn(variables["params"], rng)
    _perturb_bn(variables["batch_stats"], rng)
    jv = jax.tree.map(jnp.asarray, variables)
    logits = {
        impl: np.asarray(JaxMNASNet(alpha=0.35, num_classes=8, dw_impl=impl,
                                    precision="highest").apply(jv, jnp.asarray(x), train=False))
        for impl in ("xla", "pallas")
    }
    return variables, x, logits


def _port(variables, **kw):
    model = create_model("mnasnet0_35", num_classes=8, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables, 0.35), strict=True)
    return model


@pytest.mark.parametrize("impl,jax_impl,tol", [
    ("torch", "xla", 1e-4),
    ("auto", "xla", 1e-4),
    # The fused-block tolerance of test_mbconv_fused.py:62-82.
    ("kernel", "pallas", 5e-4),
])
def test_logits_match_jax(jax_case, impl, jax_impl, tol):
    variables, x, logits = jax_case
    model = _port(variables, dw_impl=impl)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32 and out.shape == (2, 8)
    np.testing.assert_allclose(out.numpy(), logits[jax_impl], atol=tol, rtol=tol)


def test_predict_and_eval_step_take_nhwc(jax_case):
    variables, x, logits = jax_case
    model = _port(variables)
    out = make_predict_fn(model)(x)
    np.testing.assert_allclose(out.numpy(), logits["xla"], atol=1e-4, rtol=1e-4)
    labels = np.array([int(np.argmax(logits["xla"][0])), -1])
    metrics = make_eval_step(model)(x, labels)
    assert int(metrics["count"]) == 1 and int(metrics["top1"]) == 1
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_bf16_forward_close_to_fp32(jax_case, impl):
    variables, x, logits = jax_case
    model = _port(variables, dw_impl=impl, dtype=torch.bfloat16)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # bf16 keeps ~3 decimal digits per op over ~20 layers
    assert np.abs(out.numpy() - logits["xla"]).max() <= 0.1 * np.abs(logits["xla"]).max()


@pytest.mark.parametrize("alpha", ALPHAS)
def test_param_count_and_state_dict_keys(alpha):
    model = create_model(_arch(alpha), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == EXPECTED_PARAMS[alpha]
    ref = TorchMNASNet(alpha).state_dict()
    ours = model.state_dict()
    assert list(ours) == list(ref)
    assert all(ours[k].shape == ref[k].shape for k in ref)


def test_matches_torch_module_tree():
    """A torchvision-layout state_dict loads strictly and gives the torch
    module tree's logits."""
    tm = TorchMNASNet(0.5, num_classes=10).eval()
    randomize_bn_stats(tm, seed=1)
    model = create_model("mnasnet0_5", num_classes=10, device="cpu", dw_impl="kernel")
    model.load_state_dict(tm.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), tm(x).numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_count_macs_matches_jax(alpha):
    for size in (64, 224):
        assert count_macs(alpha, size) == jax_count_macs(alpha, size)
    if alpha == 1.0:
        assert count_macs(alpha, 224) == 314_415_872  # 314.4M


def test_create_model_names_and_seed():
    assert sorted(MODEL_REGISTRY) == ["mnasnet0_35", "mnasnet0_5", "mnasnet0_75",
                                      "mnasnet1_0", "mnasnet1_3", "mnasnet1_4"]
    m = create_model("mnasnet0_9", device="cpu", num_classes=4)
    assert isinstance(m, MNASNet) and m.alpha == 0.9 and not m.training
    a = create_model("mnasnet0_35", device="cpu", seed=3).state_dict()
    b = create_model("mnasnet0_35", device="cpu", seed=3).state_dict()
    c = create_model("mnasnet0_35", device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.weight"], c["layers.0.weight"])
    for bad in ("resnet50", "mnasnet1", "mnasnetx_5"):
        with pytest.raises(ValueError):
            create_model(bad, device="cpu")
    with pytest.raises(ValueError):
        create_model("mnasnet0_35", device="cpu", dw_impl="pallas")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("mnasnet0_35")


def test_train_mode_forward_is_not_ported():
    """The train-mode forward is ported (tests/test_torch_train.py holds the
    step to JAX); the reference's training knobs that are not ported yet
    (``remat``, ``channel_pad``, ``pw_lowering``, the ``taps``/``taps2``/
    ``hybrid`` depthwise routes) are refused, and the inference-only fused
    block never runs in train mode."""
    from mnasnet_tpu_torch.models.mnasnet import InvertedResidual

    model = create_model("mnasnet0_35", device="cpu").train()
    out = model(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0)))
    assert out.shape == (2, 1000) and out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(int(b) == 1 for n, b in model.named_buffers() if n.endswith("num_batches_tracked"))
    for knob in (dict(remat=True), dict(channel_pad=8), dict(pw_lowering="dot")):
        with pytest.raises(TypeError):
            create_model("mnasnet0_35", device="cpu", **knob)
    for impl in ("taps", "taps2", "hybrid"):
        with pytest.raises(ValueError):
            create_model("mnasnet0_35", device="cpu", dw_impl=impl)
    with pytest.raises(ValueError):
        create_model("mnasnet0_35", device="cpu", bn_bwd="pallas_region")
    block = InvertedResidual(24, 24, 3, 1, 3, dw_impl="kernel")
    x = torch.zeros(1, 24, 8, 8)
    assert block.eval()._use_fused_block(x, "kernel")
    assert not block.train()._use_fused_block(x, "kernel")


def test_block_without_a_plan_takes_the_dw_kernel_route():
    """A block the fused kernel has no shared-memory plan for runs unfused on
    the kernel route (expand, the dw kernel, project) and matches the torch
    route."""
    from mnasnet_tpu_torch.models.mnasnet import InvertedResidual
    from mnasnet_tpu_torch.ops.cuda.dw_conv import dw_conv_bn_act
    from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fits_smem

    assert not mbconv_fits_smem(7, 7, 4096, 4096, 4096, 3, 1, 4)
    torch.manual_seed(0)
    kernel = InvertedResidual(4096, 4096, 3, 1, 1, dw_impl="kernel").eval()
    ref = InvertedResidual(4096, 4096, 3, 1, 1, dw_impl="torch").eval()
    for m in (kernel, ref):
        for p in m.parameters():
            torch.nn.init.normal_(p, std=0.02, generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, 4096, 7, 7).contiguous(memory_format=torch.channels_last)
    before = dw_conv_bn_act.launches
    with torch.no_grad():
        np.testing.assert_allclose(kernel(x).numpy(), ref(x).numpy(), atol=1e-5)
    assert dw_conv_bn_act.launches == before  # CPU tensors take the plain version
