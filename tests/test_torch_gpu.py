"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips (inside the test) where
``torch.cuda.is_available()`` is false. This file imports neither JAX nor the
JAX package, so it also runs on a machine with only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.ops.cuda import dw_conv, mbconv
from mnasnet_tpu_torch.ops.cuda.dw_conv import dw_conv_bn_act, dw_conv_reference
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fused, mbconv_reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, tol):
    """max |out - ref| within ``tol`` of the largest reference magnitude (the
    tolerances and their reasons are chip_smoke.py's)."""
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert float(err) <= tol, float(err)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("k,stride,hw,c", [
    (3, 1, 16, 32), (5, 1, 14, 48), (3, 2, 16, 32), (5, 2, 15, 8), (3, 1, 7, 160),
])
def test_dw_kernel_matches_plain(cuda, dtype, tol, k, stride, hw, c):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, hw, hw, c, device=cuda, generator=g).to(dtype)
    w = torch.randn(k, k, 1, c, device=cuda, generator=g) * 0.3
    s = torch.rand(c, device=cuda, generator=g) + 0.5
    b = torch.randn(c, device=cuda, generator=g)
    for relu in (True, False):
        before = dw_conv_bn_act.launches
        y = dw_conv_bn_act(x, w, s, b, stride=stride, relu=relu)
        torch.cuda.synchronize()
        assert dw_conv_bn_act.launches == before + 1
        assert y.dtype == dtype and y.is_contiguous()
        _close(y, dw_conv_reference(x, w, s, b, stride=stride, relu=relu), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("h,cin,cmid,cout,k,stride,res", [
    (16, 16, 48, 24, 3, 2, False),
    (16, 24, 72, 24, 3, 1, True),
    (14, 40, 240, 80, 5, 2, False),
    (7, 96, 576, 96, 3, 1, True),
    (15, 8, 24, 8, 5, 2, False),
    (30, 24, 72, 24, 5, 1, True),   # several tiles per sample, ragged edge
])
def test_mbconv_kernel_matches_plain(cuda, dtype, tol, h, cin, cmid, cout, k, stride, res):
    g = torch.Generator(device=cuda).manual_seed(1)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=cuda, generator=g) * scale

    x = r(2, h, h, cin).to(dtype)
    args = (x, r(cin, cmid, scale=cin ** -0.5), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
            r(k, k, 1, cmid, scale=1 / k), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
            r(cmid, cout, scale=cmid ** -0.5), r(cout).abs() + 0.5, r(cout, scale=0.1))
    kw = dict(kernel_size=k, stride=stride, residual=res)
    before = mbconv_fused.launches
    y = mbconv_fused(*args, **kw)
    torch.cuda.synchronize()
    assert mbconv_fused.launches == before + 1
    _close(y, mbconv_reference(*args, **kw), tol)


def test_smem_formulas_match_the_sources(cuda):
    dw_lib, mb_lib = dw_conv._lib(), mbconv._lib()
    for k, s, wo, th, cb, eb in [(3, 1, 112, 4, 32, 2), (5, 2, 14, 7, 64, 4)]:
        assert dw_lib.dw_conv_smem_bytes(k, s, wo, th, cb, eb) == \
            dw_conv.smem_bytes(k, s, wo, th, cb, eb)
    for args in [(16, 16, 16, 16, 24, 3, 2, 2), (7, 7, 64, 192, 320, 3, 1, 4),
                 (14, 8, 32, 80, 80, 5, 1, 2)]:
        assert mb_lib.mbconv_smem_bytes(*args) == mbconv.smem_bytes(*args)


def test_model_kernel_route_matches_torch_route(cuda):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 64, 64))
                         .astype(np.float32)).to(cuda)
    ref = create_model("mnasnet0_5", num_classes=10, dw_impl="torch")
    model = create_model("mnasnet0_5", num_classes=10, dw_impl="auto")
    model.load_state_dict(ref.state_dict())
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == (1, 16)
    with torch.no_grad():
        _close(out, ref(x), 1e-4)


def test_block_without_a_plan_takes_the_dw_kernel(cuda):
    from mnasnet_tpu_torch.models.mnasnet import InvertedResidual

    kernel = InvertedResidual(4096, 4096, 3, 1, 1, dw_impl="auto").to(cuda).eval()
    ref = InvertedResidual(4096, 4096, 3, 1, 1, dw_impl="torch").to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(2)
    with torch.no_grad():
        for p in kernel.parameters():
            p.normal_(std=0.02, generator=g)
    ref.load_state_dict(kernel.state_dict())
    x = torch.randn(2, 4096, 7, 7, device=cuda).contiguous(memory_format=torch.channels_last)
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    with torch.no_grad():
        out = kernel(x)
        torch.cuda.synchronize()
        assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == (1, 0)
        _close(out, ref(x), 1e-4)


def test_cuda_wrappers_reject(cuda):
    x = torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.float16)
    w, s, b = (torch.zeros(3, 3, 1, 16, device=cuda), torch.ones(16, device=cuda),
               torch.zeros(16, device=cuda))
    with pytest.raises(TypeError):
        dw_conv_bn_act(x, w, s, b)
    with pytest.raises(ValueError, match="contiguous"):
        dw_conv_bn_act(torch.zeros(1, 16, 8, 8, device=cuda).permute(0, 2, 3, 1), w, s, b)
    with pytest.raises(ValueError, match="even"):
        dw_conv_bn_act(torch.zeros(1, 8, 8, 15, device=cuda), w[..., :15], s[:15], b[:15])
