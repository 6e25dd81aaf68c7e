"""The PyTorch port's depthwise and MBConv ops against the JAX package.

The same numpy inputs go through the Pallas functions (interpret mode on the
CPU, as tests/test_pallas_dw.py and tests/test_mbconv_fused.py run them) and
through the port's kernel wrappers, which on a CPU tensor run their plain
PyTorch versions. The CUDA kernels themselves are held against those plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mnasnet_tpu.models.mnasnet import STACKS as JAX_STACKS
from mnasnet_tpu.models.mnasnet import get_depths as jax_get_depths
from mnasnet_tpu.ops.depthwise import _xla_depthwise
from mnasnet_tpu.ops.pallas.dw_conv import depthwise_conv_fused_pallas
from mnasnet_tpu.ops.pallas.mbconv import mbconv_fused as jax_mbconv_fused
from mnasnet_tpu_torch.ops.cuda import dw_conv, mbconv
from mnasnet_tpu_torch.ops.cuda.dw_conv import dw_conv_bn_act
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fits_smem, mbconv_fused
from mnasnet_tpu_torch.ops.depthwise import (
    depthwise_conv2d,
    depthwise_conv_bn_relu_fused,
    resolve_impl,
)

ALPHAS = (0.35, 0.5, 0.75, 1.0, 1.3, 1.4)


def _dw_inputs(h, c, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, h, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, 1, c)) * 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    return x, w, scale, bias


def _mb_inputs(h, cin, cmid, cout, k, seed=0):
    r = np.random.default_rng(seed)
    f32 = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f32(2, h, h, cin)
    we = f32(cin, cmid) * 0.2
    wd = f32(k, k, 1, cmid) * 0.3
    wp = f32(cmid, cout) * 0.2
    se, sd, sp = (r.uniform(0.5, 1.5, c).astype(np.float32) for c in (cmid, cmid, cout))
    be, bd, bp = (f32(c) * 0.1 for c in (cmid, cmid, cout))
    return x, we, se, be, wd, sd, bd, wp, sp, bp


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_close(out: np.ndarray, ref: np.ndarray, ulps: int) -> None:
    """|out - ref| within ``ulps`` bf16 ulps of the largest reference value:
    both sides sum the same fp32 products in another order, so a rounding to
    bf16 can flip by one ulp where the sums differ in their last bit."""
    err = np.abs(out - ref).max()
    assert err <= ulps * 2.0 ** -7 * np.abs(ref).max(), err


# The cases of tests/test_pallas_dw.py:27-34.
DW_CASES = [
    (3, 1, 16, 32),
    (5, 1, 14, 48),
    (3, 2, 16, 32),
    (5, 2, 28, 24),
    (3, 1, 7, 160),
    (5, 2, 15, 8),
]


@pytest.mark.parametrize("k,stride,hw,c", DW_CASES)
def test_dw_plain_matches_pallas(k, stride, hw, c):
    x, w, scale, bias = _dw_inputs(hw, c, k)
    ref = depthwise_conv_fused_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                      jnp.asarray(bias), stride=stride, padding=k // 2,
                                      relu=True)
    out = dw_conv_bn_act(_t(x), _t(w), _t(scale), _t(bias), stride=stride, relu=True)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_dw_plain_bf16_matches_pallas():
    x, w, scale, bias = _dw_inputs(16, 32, 3)
    ref = depthwise_conv_fused_pallas(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                                      jnp.asarray(scale), jnp.asarray(bias), stride=1,
                                      padding=1, relu=True)
    out = dw_conv_bn_act(_t(x).to(torch.bfloat16), _t(w), _t(scale), _t(bias), stride=1)
    assert out.dtype == torch.bfloat16
    _bf16_close(out.float().numpy(), np.asarray(ref, np.float32), ulps=1)


@pytest.mark.parametrize("impl", ["torch", "kernel", "auto"])
@pytest.mark.parametrize("k,stride", [(3, 1), (5, 2)])
def test_depthwise_routes_match_xla(impl, k, stride):
    x, w, scale, bias = _dw_inputs(12, 24, k, seed=1)
    ref = _xla_depthwise(jnp.asarray(x), jnp.asarray(w), stride, k // 2, precision="highest")
    out = depthwise_conv2d(_t(x), _t(w), stride=stride, impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    fused = depthwise_conv_bn_relu_fused(_t(x), _t(w), _t(scale), _t(bias), stride=stride,
                                         impl=impl)
    np.testing.assert_allclose(fused.numpy(), np.maximum(np.asarray(ref) * scale + bias, 0),
                               atol=1e-5)


def test_resolve_impl():
    cpu = torch.zeros(1)
    assert resolve_impl("auto", cpu) == "torch"
    assert resolve_impl("kernel", cpu) == "kernel"
    with pytest.raises(ValueError):
        resolve_impl("pallas", cpu)


# The cases of tests/test_mbconv_fused.py:29-36.
MB_CASES = [
    (16, 16, 48, 24, 3, 2, False),
    (16, 24, 72, 24, 3, 1, True),
    (14, 40, 240, 80, 5, 2, False),
    (14, 80, 480, 80, 5, 1, True),
    (7, 96, 576, 96, 3, 1, True),
    (15, 8, 24, 8, 5, 2, False),
]


@pytest.mark.parametrize("h,cin,cmid,cout,k,stride,res", MB_CASES)
def test_mbconv_plain_matches_pallas(h, cin, cmid, cout, k, stride, res):
    args = _mb_inputs(h, cin, cmid, cout, k)
    kw = dict(kernel_size=k, stride=stride, residual=res)
    ref = jax_mbconv_fused(*map(jnp.asarray, args), **kw)
    out = mbconv_fused(*map(_t, args), **kw)
    assert out.shape == ref.shape
    # 2e-4, the tolerance and the reason of test_mbconv_fused.py:43-44.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_mbconv_plain_bf16_matches_pallas():
    x, *rest = _mb_inputs(14, 40, 240, 80, 5)
    kw = dict(kernel_size=5, stride=1, residual=False)
    ref = jax_mbconv_fused(jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, rest), **kw)
    out = mbconv_fused(_t(x).to(torch.bfloat16), *map(_t, rest), **kw)
    assert out.dtype == torch.bfloat16
    _bf16_close(out.float().numpy(), np.asarray(ref, np.float32), ulps=2)


def _blocks(alpha, image=224):
    d = jax_get_depths(alpha)
    hw, cin = image // 2, d[1]
    for s, (k, stride, exp, repeats) in enumerate(JAX_STACKS):
        for j in range(repeats):
            st = stride if j == 0 else 1
            yield hw, cin, cin * exp, d[2 + s], k, st
            hw, cin = (hw + 2 * (k // 2) - k) // st + 1, d[2 + s]


@pytest.mark.parametrize("alpha", ALPHAS)
def test_fits_smem_admits_every_block_at_224(alpha):
    blocks = list(_blocks(alpha))
    assert len(blocks) == 16
    for h, cin, cmid, cout, k, s in blocks:
        for eb in (2, 4):
            p = mbconv.plan(h, h, cin, cmid, cout, k, s, eb)
            assert p is not None, (h, cin, cmid, cout, k, s, eb)
            assert p.smem == mbconv.smem_bytes(p.th, p.tw, p.mc, cin, cout, k, s, eb)
            assert p.smem <= mbconv.SMEM_LIMIT and p.th * p.tw <= 256


def test_fits_smem_rejects():
    assert not mbconv_fits_smem(7, 7, 2048, 12288, 2048, 5, 1)  # x halo alone > 227 KB
    assert not mbconv_fits_smem(14, 14, 24, 76, 24, 3, 1)       # Cmid not a multiple of 8
    assert not mbconv_fits_smem(14, 14, 24, 72, 24, 7, 1)       # k = 7


def test_plan_counts_halo_recompute():
    # A whole 7x7 plane in one tile expands each input pixel once; 56x56 in
    # tiles re-expands the halo rows and columns of each tile.
    p7 = mbconv.plan(7, 7, 192, 1152, 320, 3, 1)
    assert (p7.th, p7.tw, p7.expand_px) == (7, 7, 49)
    p56 = mbconv.plan(56, 56, 24, 72, 24, 3, 1)
    assert 56 * 56 < p56.expand_px < 1.5 * 56 * 56


def test_dw_plan_fits_budget():
    for h, c, k, s in [(112, 32, 3, 1), (112, 48, 3, 2), (7, 1152, 5, 1), (15, 8, 5, 2)]:
        for eb in (2, 4):
            th, cb = dw_conv.plan(128, h, h, c, k, s, eb)
            assert cb % 2 == 0 and cb <= 64 and th >= 1
            wo = dw_conv.out_size(h, k, s)
            assert dw_conv.smem_bytes(k, s, wo, th, cb, eb) <= dw_conv.SMEM_BUDGET or th == 1


def test_kernel_shapes_of_mnasnet1_0():
    """The shapes chip_smoke.py and the plan sweep hold the kernels at are the
    model's own: 16 MBConv blocks and 12 distinct depthwise convs."""
    from mnasnet_tpu_torch.tools.tune_plans import block_shapes, dw_shapes

    assert [b[1:] for b in block_shapes(1.0)] == list(_blocks(1.0))
    assert dw_shapes(1.0) == [
        (112, 32, 3, 1), (112, 48, 3, 2), (56, 72, 3, 1), (56, 72, 5, 2),
        (28, 120, 5, 1), (28, 240, 5, 2), (14, 480, 5, 1), (14, 480, 3, 1),
        (14, 576, 3, 1), (14, 576, 5, 2), (7, 1152, 5, 1), (7, 1152, 3, 1),
    ]
