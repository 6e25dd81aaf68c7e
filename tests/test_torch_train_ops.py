"""The PyTorch port's training ops and layers against the JAX package.

The same numpy inputs go through the JAX functions (the Pallas BN+ReLU
region in interpret mode, as tests/test_bn_bwd.py runs it; the Pallas dw
conv likewise) and through the port, whose kernel wrappers run their plain
PyTorch versions on CPU tensors. Tolerances: fp32 at rtol = atol = 2e-4 (the
tolerance of tests/test_bn_bwd.py:58-60 for the region's gradients), bf16
within 2 bf16 ulps of the largest reference value.
"""

import ctypes
import re
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mnasnet_tpu.models.layers import BatchNorm as JaxBatchNorm
from mnasnet_tpu.models.layers import StemConv as JaxStemConv
from mnasnet_tpu.ops.depthwise import dw_grad_weights as jax_dw_grad_weights
from mnasnet_tpu.ops.depthwise import dw_transposed_dx as jax_dw_transposed_dx
from mnasnet_tpu.ops.pallas.bn_bwd import bn_relu_train as jax_bn_relu_train
from mnasnet_tpu.ops.pallas.dw_conv import depthwise_conv_pallas
from mnasnet_tpu.train.schedules import make_schedule as jax_make_schedule
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.models.layers import BatchNorm, StemConv
from mnasnet_tpu_torch.ops.cuda import _build
from mnasnet_tpu_torch.ops.cuda import bn_bwd as bn_bwd_mod
from mnasnet_tpu_torch.ops.cuda import dw_conv as dw_conv_mod
from mnasnet_tpu_torch.ops.cuda import mbconv as mbconv_mod
from mnasnet_tpu_torch.ops.cuda import se as se_mod
from mnasnet_tpu_torch.ops.cuda.bn_bwd import (
    APPLY_TILE_MAX,
    FINISH_BYTES,
    MIN_ROWS_PER_THREAD,
    REDUCE_SMEM_LIMIT,
    _fwd_math,
    _fwd_region,
    alignment,
    apply_plan,
    batch_moments,
    bn_bwd_dx,
    bn_bwd_dx_reference,
    bn_bwd_reduce,
    bn_bwd_reduce_reference,
    bn_fwd_stats,
    bn_fwd_stats_reference,
    bn_relu_apply,
    bn_relu_apply_reference,
    bn_relu_train,
    plan,
    reduce_plan,
    region_moments,
    relu_mask_reference,
    stats_plan,
)
from mnasnet_tpu_torch.ops.cuda.dw_conv import depthwise_conv_train
from mnasnet_tpu_torch.ops.depthwise import depthwise_conv2d, dw_grad_weights, dw_transposed_dx
from mnasnet_tpu_torch.train.optim import backbone_frozen_mask, rmsprop_tf, wd_mask
from mnasnet_tpu_torch.train.schedules import make_schedule, scale_lr_for_batch



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is small: one intra-op thread is as
    fast, and keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(out, ref, dtype, tol=2e-4):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    else:
        err = np.abs(out - ref).max()
        assert err <= 2 * 2.0 ** -7 * np.abs(ref).max(), err


def _bn_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    return x, gamma, beta, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 14, 14, 72)])
def test_bn_relu_train_matches_pallas(shape, stats, dtype):
    x, gamma, beta, cot = _bn_inputs(shape)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    cotj = jnp.asarray(cot).astype(jdt)

    def loss(x_, g_, b_):
        y, _, _ = jax_bn_relu_train(x_, g_, b_, 1e-5, stats)
        return jnp.sum((y * cotj).astype(jnp.float32))

    yj, mj, vj = jax_bn_relu_train(xj, jnp.asarray(gamma), jnp.asarray(beta), 1e-5, stats)
    gj = jax.grad(loss, argnums=(0, 1, 2))(xj, jnp.asarray(gamma), jnp.asarray(beta))

    xt = _t(x).to(tdt).requires_grad_()
    gt, bt = _t(gamma).requires_grad_(), _t(beta).requires_grad_()
    y, mean, var = bn_relu_train(xt, gt, bt, 1e-5, stats)
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    (y.float() * _t(cot).to(tdt).float()).sum().backward()

    np.testing.assert_allclose(mean.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-6)
    _close(y.detach().float().numpy(), np.asarray(yj, np.float32), dtype)
    for out, ref, name in zip((xt.grad, gt.grad, bt.grad), gj, ("dx", "dgamma", "dbeta")):
        assert out.dtype == (tdt if name == "dx" else torch.float32), name
        _close(out.float().numpy(), np.asarray(ref, np.float32), dtype)


def test_bf16_relu_mask_count_is_exact():
    """With dy = 1 the region's dβ is the per-channel count of unmasked
    elements, fp32-exact: it must equal the count of positive forward
    outputs (tests/test_bn_bwd.py:63-86). A mask recomputed in fp32 would
    disagree at sign boundaries."""
    rng = np.random.default_rng(0)
    shape = (8, 8, 8, 64)
    x = _t(rng.standard_normal(shape)).to(torch.bfloat16)
    gamma = _t(rng.uniform(0.5, 1.5, 64))
    beta = _t(rng.uniform(-0.5, 0.5, 64)).requires_grad_()
    y, _, _ = bn_relu_train(x, gamma, beta, 1e-5, "two_pass")
    y.float().sum().backward()
    count = (y > 0).float().sum(dim=(0, 1, 2))
    assert torch.equal(beta.grad, count)


def test_reduce_and_dx_wrappers_take_the_plain_versions_on_cpu():
    x, gamma, beta, cot = _bn_inputs((2, 6, 6, 24), seed=3)
    x, dy = _t(x), _t(cot)
    mean, var = x.mean(dim=(0, 1, 2)), x.var(dim=(0, 1, 2), unbiased=False)
    inv = torch.rsqrt(var + 1e-5)
    vecs = (mean, inv, _t(gamma), _t(beta))
    before = (bn_bwd_reduce.launches, bn_bwd_dx.launches)
    dg, db = bn_bwd_reduce(x, dy, *vecs)
    ref = bn_bwd_reduce_reference(x, dy, *vecs)
    assert torch.equal(dg, ref[0]) and torch.equal(db, ref[1])
    assert torch.equal(bn_bwd_dx(x, dy, *vecs, dg, db), bn_bwd_dx_reference(x, dy, *vecs, dg, db))
    assert (bn_bwd_reduce.launches, bn_bwd_dx.launches) == before
    with pytest.raises(ValueError, match="dy"):
        bn_bwd_reduce(x, dy[:1], *vecs)
    with pytest.raises(ValueError, match="per-channel"):
        bn_bwd_dx(x, dy, mean[:3], inv, _t(gamma), _t(beta), dg, db)


@pytest.mark.parametrize("m,c", [(128 * 112 * 112, 48), (128 * 49, 1280), (256, 16), (10, 2)])
def test_bn_plan(m, c):
    tp, r, slabs = plan(m, c)
    tiles = -(-(c // 2) // tp)
    assert tp * r <= 256 and (tiles - 1) * tp < c // 2 <= tiles * tp
    assert 1 <= slabs and slabs * tiles <= 8 * 132 + tiles
    if m >= 8 * 132 * 8 * r:  # a large plane fills the grid
        assert slabs * tiles >= 8 * 132


def _check_reduce_plan(m, c, itemsize, align=16, inputs=2):
    """The launch the reduce kernel makes from ``reduce_plan(m, c, itemsize,
    align)``, walked as ``bn_reduce_kernel`` walks it (csrc/bn_bwd.cu);
    ``inputs=1``: the stats kernel's from ``stats_plan``, walked as
    ``bn_stats_kernel`` walks it (no factors in shared memory)."""
    p = reduce_plan(m, c, itemsize, align) if inputs == 2 else stats_plan(m, c, itemsize, align)
    # The vector: 16, 8 or 4 bytes, at least two elements, dividing C and
    # the alignment.
    assert p.vec_bytes in (16, 8, 4) and p.vec_bytes == p.vec * itemsize and p.vec >= 2
    assert c % p.vec == 0 and align % p.vec_bytes == 0
    wider = [b for b in (16, 8, 4) if b > p.vec_bytes and b // itemsize >= 2]
    assert not any(c % (b // itemsize) == 0 and align % b == 0 for b in wider)
    # Every channel group in exactly one (tile, group) of a block.
    groups = c // p.vec
    owned = [t * p.tg + g for t in range(p.tiles) for g in range(p.tg) if t * p.tg + g < groups]
    assert sorted(owned) == list(range(groups))
    assert (p.tiles - 1) * p.tg < groups  # no empty tile
    # Every row in exactly one slab, no slab empty.
    assert p.rows_per_slab * (p.slabs - 1) < m <= p.rows_per_slab * p.slabs
    # Grid and block limits (the C entry point refuses what breaks them).
    assert p.threads % 32 == 0 and p.threads <= 256 and 1 <= p.tg <= p.threads
    assert p.lanes == p.threads // p.tg >= 1
    assert p.tiles < 2 ** 31 and 1 <= p.slabs <= 65535
    factors = p.tg * p.vec * 16 if inputs == 2 else 0
    assert p.smem == factors + p.lanes * (2 * p.tg * p.vec + 1) * 4 <= REDUCE_SMEM_LIMIT
    # The scratch holds every partial row a block writes: [tiles][slabs][2][tg * vec].
    last = ((p.tiles - 1) * p.slabs + p.slabs - 1) * 2 * p.tg * p.vec + 2 * p.tg * p.vec
    assert p.partial_floats >= last
    # The finish reads the tile's partials: 2 x slabs x tile channels fp32.
    assert p.finish_bytes == 2 * p.slabs * p.tg * p.vec * 4 <= FINISH_BYTES
    return p


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("alpha", [0.35, 0.5, 0.75, 1.0, 1.3, 1.4])
def test_reduce_plans_of_every_alpha(alpha, itemsize):
    """Every BN+ReLU region of the training forward at 224 px, batch 128:
    16-byte vectors (every C of the family is a multiple of 8) and a grid
    that fills the card within the finish's bound."""
    from mnasnet_tpu_torch.tools.tune_plans import bn_region_shapes

    regions = bn_region_shapes(alpha)
    assert len(regions) == 35
    for _, h, c in regions:
        p = _check_reduce_plan(128 * h * h, c, itemsize)
        assert p.vec_bytes == 16
        # A block per SM at least, unless the region is too small to give
        # each lane MIN_ROWS_PER_THREAD rows.
        assert p.tiles * p.slabs >= 132 or p.rows_per_slab <= p.lanes * MIN_ROWS_PER_THREAD


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("align", [16, 8, 4])
@pytest.mark.parametrize("m", [1, 10, 256])
@pytest.mark.parametrize("c", [2, 6, 12, 72])
def test_reduce_plans_of_small_shapes(c, m, align, itemsize):
    if align < 2 * itemsize:
        with pytest.raises(ValueError, match="aligned"):
            reduce_plan(m, c, itemsize, align)
    else:
        _check_reduce_plan(m, c, itemsize, align)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("alpha", [0.35, 0.5, 0.75, 1.0, 1.3, 1.4])
def test_forward_plans_of_every_alpha(alpha, itemsize):
    """The stats and apply kernels' launches at every BN+ReLU region of the
    training forward at 224 px, batch 128: 16-byte vectors, the stats grid
    the reduce's, the apply grid full unless a lane would walk fewer than
    MIN_ROWS_PER_THREAD rows."""
    from mnasnet_tpu_torch.tools.tune_plans import bn_region_shapes

    for _, h, c in bn_region_shapes(alpha):
        m = 128 * h * h
        p = _check_reduce_plan(m, c, itemsize, inputs=1)
        assert p.vec_bytes == 16 and p._replace(smem=0) == reduce_plan(m, c, itemsize)._replace(
            smem=0)
        a = _check_apply_plan(m, c, itemsize)
        assert a.vec_bytes == 16
        # (slabs left empty by rounding the rows up are dropped: 1% at most)
        assert 100 * a.tiles * a.slabs >= 99 * 8 * 132 \
            or a.rows_per_slab <= a.lanes * MIN_ROWS_PER_THREAD


def _check_apply_plan(m, c, itemsize, align=16):
    """The launch the apply kernel makes from ``apply_plan(m, c, itemsize,
    align)``, walked as ``bn_apply_relu_kernel`` walks it (csrc/bn_bwd.cu)."""
    p = apply_plan(m, c, itemsize, align)
    assert p.vec_bytes == reduce_plan(m, c, itemsize, align).vec_bytes == p.vec * itemsize
    groups = c // p.vec
    # Tiles of tg vectors cover the row exactly; at most a sixteenth of a
    # block's threads idle.
    assert groups % p.tg == 0 and p.tiles * p.tg == groups and p.tg <= APPLY_TILE_MAX
    assert p.threads == 256 and p.lanes == p.threads // p.tg
    assert 16 * p.lanes * p.tg >= 15 * p.threads
    assert p.rows_per_slab * (p.slabs - 1) < m <= p.rows_per_slab * p.slabs
    assert 1 <= p.slabs <= 65535
    return p


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("align", [16, 8, 4])
@pytest.mark.parametrize("m", [1, 10, 256])
@pytest.mark.parametrize("c", [2, 6, 12, 72])
def test_forward_plans_of_small_shapes(c, m, align, itemsize):
    if align < 2 * itemsize:
        for fn in (stats_plan, apply_plan):
            with pytest.raises(ValueError, match="aligned"):
                fn(m, c, itemsize, align)
    else:
        _check_reduce_plan(m, c, itemsize, align, inputs=1)
        _check_apply_plan(m, c, itemsize, align)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 14, 14, 72), (3, 5, 5, 6)])
def test_forward_ops_on_cpu_are_the_plain_arithmetic(shape, dtype):
    """The two forward ops' CPU impls: the sums of ``batch_moments`` (fp32,
    float64 staying float64) and the two-op apply of ``_fwd_math``, bit for
    bit; the wrappers are the ops and count no launch on the CPU."""
    x, gamma, beta, _ = _bn_inputs(shape, seed=4)
    x, gamma, beta = _t(x).to(dtype), _t(gamma), _t(beta)
    before = (bn_fwd_stats.launches, bn_relu_apply.launches)
    sums = bn_fwd_stats(x)
    x32 = x.to(torch.promote_types(dtype, torch.float32))
    assert sums.shape == (2, shape[-1]) and sums.dtype == x32.dtype
    assert torch.equal(sums[0], x32.sum(dim=(0, 1, 2)))
    assert torch.equal(sums[1], x32.square().sum(dim=(0, 1, 2)))
    mean = sums[0] / (x.numel() // shape[-1])
    shifted = bn_fwd_stats(x, mean)
    assert torch.equal(shifted[1], (x32 - mean).square().sum(dim=(0, 1, 2)))
    assert torch.equal(shifted, bn_fwd_stats_reference(x, mean))
    _, m, v = _fwd_math(x, gamma, beta, 1e-5, "one_pass")
    vecs = (m, torch.rsqrt(v + 1e-5), gamma, beta)
    y = bn_relu_apply(x, *vecs)
    assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
    assert torch.equal(y, _fwd_math(x, gamma, beta, 1e-5, "one_pass")[0])
    assert torch.equal(y, bn_relu_apply_reference(x, *vecs))
    assert torch.equal(y > 0, relu_mask_reference(x, *vecs))
    assert (bn_fwd_stats.launches, bn_relu_apply.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_region_forward_on_the_ops_is_the_plain_forward_on_cpu(stats, dtype):
    """The region's forward through the ops (``_fwd_region``,
    ``region_moments``) is ``_fwd_math`` / ``batch_moments`` bit for bit on
    the CPU: y, the mean and the variance."""
    x, gamma, beta, _ = _bn_inputs((2, 14, 14, 72), seed=6)
    x = _t(x).to(dtype)
    gamma, beta = _t(gamma).to(torch.promote_types(dtype, torch.float32)), _t(beta)
    assert all(torch.equal(a, b) for a, b in zip(region_moments(x, stats),
                                                 batch_moments(x, stats)))
    assert all(torch.equal(a, b) for a, b in zip(_fwd_region(x, gamma, beta, 1e-5, stats),
                                                 _fwd_math(x, gamma, beta, 1e-5, stats)))
    with pytest.raises(ValueError, match="unknown BN stats"):
        region_moments(x, "three_pass")


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_region_on_an_empty_band_runs_no_op(stats, monkeypatch):
    """An empty band (a plane with fewer rows than ranks): the region's
    forward calls neither forward op, and y is empty."""
    called = []
    for name in ("bn_fwd_stats", "bn_relu_apply"):
        op = getattr(torch.ops.mnasnet_tpu_torch, name)
        monkeypatch.setattr(torch.ops.mnasnet_tpu_torch, name, types.SimpleNamespace(
            default=lambda *a, op=op, name=name: called.append(name) or op.default(*a)))
    x = torch.empty(2, 0, 7, 16)
    y, mean, var = bn_relu_train(x, torch.ones(16), torch.zeros(16), 1e-5, stats)
    assert y.shape == x.shape and mean.shape == var.shape == (16,) and not called
    y, _, _ = bn_relu_train(torch.ones(2, 1, 7, 16), torch.ones(16), torch.zeros(16), 1e-5, stats)
    assert called.count("bn_fwd_stats") == (1 if stats == "one_pass" else 2)
    assert called.count("bn_relu_apply") == 1


def _fake_cuda(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="cuda", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_ops_fake_impls(dtype):
    """The fake impls on CUDA tensors (no card needed): the output shapes
    and dtypes, and the CUDA checks: an odd C, a 3-d input, a strided input,
    a vector on another device, another dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ops = torch.ops.mnasnet_tpu_torch
    with FakeTensorMode():
        x, v = _fake_cuda(2, 5, 5, 6, dtype=dtype), _fake_cuda(6)
        sums = ops.bn_fwd_stats.default(x, None)
        assert sums.shape == (2, 6) and sums.dtype == torch.float32 and sums.is_cuda
        assert ops.bn_fwd_stats.default(x, v).shape == (2, 6)
        y = ops.bn_relu_apply.default(x, v, v, v, v)
        assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous() and y.is_cuda
        odd = _fake_cuda(2, 5, 5, 7, dtype=dtype)
        with pytest.raises(ValueError, match="even channel count"):
            ops.bn_fwd_stats.default(odd, None)
        with pytest.raises(ValueError, match="even channel count"):
            ops.bn_relu_apply.default(odd, *[_fake_cuda(7)] * 4)
        with pytest.raises(ValueError, match="NHWC"):
            ops.bn_fwd_stats.default(_fake_cuda(10, 6, dtype=dtype), None)
        with pytest.raises(ValueError, match="NHWC"):
            ops.bn_relu_apply.default(_fake_cuda(10, 6, dtype=dtype), v, v, v, v)
        strided = _fake_cuda(2, 6, 5, 5, dtype=dtype).permute(0, 2, 3, 1)
        with pytest.raises(ValueError, match="contiguous"):
            ops.bn_relu_apply.default(strided, v, v, v, v)
        with pytest.raises(ValueError, match="x's device"):
            ops.bn_fwd_stats.default(x, torch.empty(6))
        with pytest.raises(ValueError, match="x's device"):
            ops.bn_relu_apply.default(x, v, torch.empty(6), v, v)
        with pytest.raises(TypeError, match="bf16 or fp32"):
            ops.bn_fwd_stats.default(_fake_cuda(2, 5, 5, 6, dtype=torch.float16), None)


def test_forward_ops_cpu_checks_and_autograd_refusal():
    """The CPU impls take any even or odd C but refuse a non-NHWC input, a
    vector of another width and a vector on another device; the wrappers
    refuse an input that requires grad."""
    x, v = torch.randn(2, 3, 3, 5), torch.randn(5)
    assert bn_fwd_stats(x).shape == (2, 5) and bn_relu_apply(x, v, v, v, v).shape == x.shape
    with pytest.raises(ValueError, match="NHWC"):
        bn_fwd_stats(torch.randn(9, 5))
    with pytest.raises(ValueError, match="per-channel"):
        bn_relu_apply(x, v[:3], v, v, v)
    with pytest.raises(ValueError, match="x's device"):
        bn_fwd_stats(x, torch.empty(5, device="meta"))
    with pytest.raises(RuntimeError, match="autograd"):
        bn_relu_apply(x.requires_grad_(), v, v, v, v)


def test_alignment_of_addresses():
    assert alignment(0) == 16 and alignment(4096, 32) == 16
    assert alignment(4096, 4104) == 8 and alignment(300) == 4 and alignment(16, 2) == 2


def _c_signatures(source):
    """{name: (return type, [parameter types])} of the functions in the
    ``extern "C"`` block of a CUDA source."""
    text = re.sub(r"//[^\n]*", "", source.split('extern "C" {', 1)[1])
    text = re.sub(r"#ifdef.*?#endif", "", text, flags=re.S)
    out = {}
    for ret, name, params in re.findall(r"(int|long long)\s+(\w+)\(([^)]*)\)\s*\{", text):
        types = [re.sub(r"\s*\b\w+$", "", p.strip()) for p in params.split(",")]
        out[name] = (ret, types)
    return out


_CTYPES_OF = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.mark.parametrize("module,fn", [
    (bn_bwd_mod, "bn_bwd_reduce"), (bn_bwd_mod, "bn_bwd_dx"),
    (bn_bwd_mod, "bn_fwd_stats"), (bn_bwd_mod, "bn_relu_apply"),
    (bn_bwd_mod, "bn_silu_bwd_reduce"), (bn_bwd_mod, "bn_silu_bwd_dx"),
    (bn_bwd_mod, "bn_silu_apply"),
    (dw_conv_mod, "dw_conv_bn_act"), (dw_conv_mod, "dw_conv_smem_bytes"),
    (mbconv_mod, "mbconv_block"), (mbconv_mod, "mbconv_smem_bytes"),
    (se_mod, "se_pool"), (se_mod, "se_scale"), (se_mod, "se_dgate"), (se_mod, "se_dx"),
])
def test_prototypes_match_the_sources(module, fn):
    """The ctypes prototypes pass each argument as the C entry point takes it:
    every pointer (and the stream) as c_void_p, never as a 32-bit int."""
    name = module.__name__.rsplit(".", 1)[1]
    source = (_build.CSRC_DIR / f"{name}.cu").read_text()
    ret, params = _c_signatures(source)[fn]
    argtypes, restype = module._PROTOTYPES[fn]
    assert restype is _CTYPES_OF[ret]
    expect = [ctypes.c_void_p if t.endswith("*") else _CTYPES_OF[t.replace("const ", "")]
              for t in params]
    assert argtypes == expect
    assert set(module._PROTOTYPES) == set(_c_signatures(source))



# ------------------------------------------------- the BN+SiLU region (EfficientNet)

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.float64, 1e-4)])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 14, 14, 72), (3, 5, 5, 6)])
def test_silu_region_on_the_cpu_ops_matches_autograd(shape, dtype, tol):
    """The BN+SiLU region (``bn_relu_train(..., act="silu")``) on the ops'
    CPU impls against autograd of its plain forward, silu((x − μ)·rsqrt(σ² +
    ε)·γ + β) with batch statistics: y, dx, dγ, dβ, in fp32 at the ReLU
    region's tolerance of tests/test_bn_bwd.py:58-60, and in float64 within
    the fp32 round-off of sums over a few hundred rows (the reduce and dx
    work in fp32, as the kernels do, for ReLU too); the statistics are
    those of the ReLU region."""
    g = torch.Generator().manual_seed(shape[-1])
    x = (torch.randn(*shape, generator=g) * 2 + 0.3).to(dtype)
    dy = torch.randn(*shape, generator=g).to(dtype)
    gamma = (torch.rand(shape[-1], generator=g) + 0.5).to(dtype)
    beta = (torch.rand(shape[-1], generator=g) - 0.5).to(dtype)
    ours = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y, mean, var = bn_relu_train(*ours, 1e-3, "one_pass", act="silu")
    y.backward(dy)
    _, mr, vr = bn_relu_train(x, gamma, beta, 1e-3, "one_pass")
    assert torch.equal(mean, mr) and torch.equal(var, vr)
    ref = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    m = ref[0].mean(dim=(0, 1, 2))
    v = ref[0].var(dim=(0, 1, 2), unbiased=False)
    yr = torch.nn.functional.silu((ref[0] - m) * torch.rsqrt(v + 1e-3) * ref[1] + ref[2])
    yr.backward(dy)
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_ops_cpu_impls_are_the_plain_arithmetic(dtype):
    """The apply, reduce and dx ops' CPU impls with ``act="silu"`` give the
    bits of the plain versions; ``act="relu"`` is the op's default; an
    unknown activation is refused by every op and the region."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 5, 5, 6, generator=g).to(dtype)
    dy = torch.randn(3, 5, 5, 6, generator=g).to(dtype)
    mean, inv = torch.randn(6, generator=g) * 0.1, torch.rand(6, generator=g) + 0.5
    gamma, beta = torch.rand(6, generator=g) + 0.5, torch.randn(6, generator=g) * 0.2
    vecs = (mean, inv, gamma, beta)
    ops = torch.ops.mnasnet_tpu_torch
    assert torch.equal(ops.bn_relu_apply.default(x, *vecs, "silu"),
                       bn_bwd_mod.bn_relu_apply_reference(x, *vecs, act="silu"))
    assert torch.equal(ops.bn_relu_apply.default(x, *vecs),
                       bn_bwd_mod.bn_relu_apply_reference(x, *vecs))
    sums = ops.bn_bwd_reduce.default(x, dy, *vecs, "silu")
    assert torch.equal(sums, torch.stack(bn_bwd_mod.bn_bwd_reduce_reference(x, dy, *vecs,
                                                                            act="silu")))
    dx = ops.bn_bwd_dx.default(x, dy, *vecs, sums[0], sums[1], 75, "silu")
    assert torch.equal(dx, bn_bwd_mod.bn_bwd_dx_reference(x, dy, *vecs, sums[0], sums[1], 75,
                                                          act="silu"))
    # SiLU's derivative at the forward's z: at dy = 1, dβ sums it.
    z = (x * (gamma * inv).to(dtype) + (beta - mean * gamma * inv).to(dtype)).float()
    s = torch.sigmoid(z)
    torch.testing.assert_close(sums[1], (s * (1 + z * (1 - s)) * dy.float()).sum((0, 1, 2)))
    with pytest.raises(ValueError, match="activation"):
        ops.bn_relu_apply.default(x, *vecs, "gelu")
    with pytest.raises(ValueError, match="activation"):
        ops.bn_bwd_reduce.default(x, dy, *vecs, "gelu")
    with pytest.raises(ValueError, match="activation"):
        bn_relu_train(x, gamma, beta, act="gelu")


def test_silu_ops_fake_impls():
    """The fake impls take the activation and keep the ReLU ops' shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ops = torch.ops.mnasnet_tpu_torch
    with FakeTensorMode():
        x, v = _fake_cuda(2, 5, 5, 6, dtype=torch.bfloat16), _fake_cuda(6)
        assert ops.bn_relu_apply.default(x, v, v, v, v, "silu").shape == x.shape
        assert ops.bn_bwd_reduce.default(x, x, v, v, v, v, "silu").shape == (2, 6)
        assert ops.bn_bwd_dx.default(x, x, v, v, v, v, v, v, 50, "silu").shape == x.shape
        with pytest.raises(ValueError, match="activation"):
            ops.bn_bwd_dx.default(x, x, v, v, v, v, v, v, 50, "tanh")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_op_silu_epilogue_on_cpu(dtype):
    """The dw op's SiLU epilogue on the CPU impl: the fp32 conv, affine and
    SiLU, one cast; ReLU and SiLU together are refused."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 9, 9, 16, generator=g).to(dtype)
    w = torch.randn(3, 3, 1, 16, generator=g) * 0.3
    s, b = torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g) * 0.1
    y = dw_conv_mod.dw_conv_bn_act(x, w, s, b, stride=2, relu=False, silu=True)
    lin = dw_conv_mod.dw_conv_reference(x, w, s, b, stride=2, relu=False).float()
    ref = torch.nn.functional.silu(
        dw_conv_mod.dw_conv_reference(x.float(), w, s, b, stride=2, relu=False))
    assert torch.equal(y, ref.to(dtype)) and (lin < 0).any()
    with pytest.raises(ValueError, match="one activation"):
        dw_conv_mod.dw_conv_bn_act(x, w, s, b, relu=True, silu=True)

# k, stride, H, C: the cases of tests/test_pallas_dw.py plus an odd size.
DW_CASES = [(3, 1, 16, 32), (5, 1, 14, 48), (3, 2, 16, 32), (5, 2, 28, 24), (5, 2, 15, 8)]


@pytest.mark.parametrize("k,stride,hw,c", DW_CASES)
def test_dw_train_function_matches_pallas(k, stride, hw, c):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, 1, c)) * 0.3).astype(np.float32)
    ho = (hw + 2 * (k // 2) - k) // stride + 1
    cot = rng.standard_normal((2, ho, ho, c)).astype(np.float32)

    def loss(x_, w_):
        return jnp.sum(depthwise_conv_pallas(x_, w_, stride=stride, padding=k // 2) * cot)

    yj = depthwise_conv_pallas(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=k // 2)
    dxj, dwj = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = depthwise_conv_train(xt, wt, stride=stride)
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dxj), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dwj), rtol=1e-5, atol=1e-4)
    # The kernel route of the dispatch is this Function; the torch route's
    # autograd gives the same gradients.
    xr, wr = _t(x).requires_grad_(), _t(w).requires_grad_()
    (depthwise_conv2d(xr, wr, stride=stride, impl="torch") * _t(cot)).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), xt.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(wr.grad.numpy(), wt.grad.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,hw", [(3, 1, 9), (5, 2, 15), (3, 2, 16)])
def test_dw_backward_helpers_match_jax(k, stride, hw, dtype):
    rng = np.random.default_rng(2)
    c = 12
    ho = (hw + 2 * (k // 2) - k) // stride + 1
    x = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, 1, c)) * 0.3).astype(np.float32)
    g = rng.standard_normal((2, ho, ho, c)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    dx_ref = jax_dw_transposed_dx(jnp.asarray(g).astype(jdt), jnp.asarray(w), stride, k // 2,
                                  hw, hw)
    dx = dw_transposed_dx(_t(g).to(tdt), _t(w), stride, k // 2, hw, hw)
    assert dx.shape == dx_ref.shape and dx.dtype == tdt
    _close(dx.float().numpy(), np.asarray(dx_ref, np.float32), dtype, tol=1e-5)
    dw_ref = jax_dw_grad_weights(jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt), k,
                                 stride, k // 2)
    dw = dw_grad_weights(_t(x).to(tdt), _t(g).to(tdt), k, stride, k // 2)
    assert dw.shape == (k, k, 1, c) and dw.dtype == torch.float32
    # Both sum the same exact fp32 products, in another order.
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), rtol=1e-5, atol=1e-4)


def _jax_bn_apply(x, params, batch_stats, train, **kw):
    bn = JaxBatchNorm(x.shape[-1], **kw)
    out, mutated = bn.apply({"params": params, "batch_stats": batch_stats}, jnp.asarray(x),
                            use_running_average=not train, mutable=["batch_stats"])
    return np.asarray(out), jax.tree.map(np.asarray, mutated["batch_stats"])


@pytest.mark.parametrize("ema", ["module", "external"])
@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_batchnorm_train_stats_and_ema_match_jax(ema, stats):
    rng = np.random.default_rng(5)
    c = 24
    x = (rng.standard_normal((4, 6, 6, c)) * 1.5 + 0.5).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    s = {"mean": (rng.standard_normal(c) * 0.1).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    kw = dict(momentum=0.9, stats=stats, ema=ema)
    y_ref, s_ref = _jax_bn_apply(x, p, s, True, **kw)

    bn = BatchNorm(c, **kw).train()
    with torch.no_grad():
        bn.weight.copy_(_t(p["scale"]))
        bn.bias.copy_(_t(p["bias"]))
        bn.running_mean.copy_(_t(s["mean"]))
        bn.running_var.copy_(_t(s["var"]))
    xt = _t(x).permute(0, 3, 1, 2)
    y = bn(xt)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), s_ref["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), s_ref["var"], rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    # The region form updates the same statistics and gives relu of the same y.
    bn2 = BatchNorm(c, **kw).train()
    bn2.load_state_dict({**bn.state_dict(), "running_mean": _t(s["mean"]),
                         "running_var": _t(s["var"]), "num_batches_tracked": torch.tensor(0)})
    y2 = bn2.relu_train_region(xt)
    np.testing.assert_allclose(y2.detach().permute(0, 2, 3, 1).numpy(), np.maximum(y_ref, 0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn2.running_var.numpy(), s_ref["var"], rtol=1e-5, atol=1e-6)
    # Eval mode normalises with the running statistics and updates nothing.
    y_eval, _ = _jax_bn_apply(x, p, s_ref, False, **kw)
    bn.eval()
    before = bn.running_mean.clone()
    np.testing.assert_allclose(bn(xt).detach().permute(0, 2, 3, 1).numpy(), y_eval,
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(bn.running_mean, before)


def test_s2d_stem_matches_plain_and_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 3, 8)) * 0.3).astype(np.float32)  # HWIO
    cot = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)

    def jax_loss(k_, s2d):
        y = JaxStemConv(8, s2d=s2d, precision="highest").apply({"params": {"kernel": k_}},
                                                               jnp.asarray(x), train=True)
        return jnp.sum(y * cot), y

    (_, y_ref), dk_ref = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(kernel), True)

    outs = {}
    for s2d in (True, False):
        stem = StemConv(8, s2d=s2d).train()
        with torch.no_grad():
            stem.weight.copy_(_t(kernel).permute(3, 2, 0, 1))
        y = stem(_t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        (y.permute(0, 2, 3, 1) * _t(cot)).sum().backward()
        outs[s2d] = (y.detach().permute(0, 2, 3, 1).numpy(),
                     stem.weight.grad.permute(2, 3, 1, 0).numpy())
    for s2d in (True, False):
        np.testing.assert_allclose(outs[s2d][0], np.asarray(y_ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(outs[s2d][1], np.asarray(dk_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(outs[True][0], outs[False][0], rtol=1e-5, atol=1e-5)


def test_rmsprop_tf_first_step_by_formula():
    model = create_model("mnasnet0_35", device="cpu", num_classes=4)
    params = dict(model.named_parameters())
    rng = np.random.default_rng(7)
    grads = {n: _t(rng.standard_normal(p.shape)) for n, p in params.items()}
    lr, decay, mom, eps, wd = 0.05, 0.9, 0.9, 1e-3, 1e-5
    tx = rmsprop_tf(lambda count: lr * (count + 1), decay, mom, eps, wd)
    tx.init(model)
    updates = tx.update(grads)
    mask = wd_mask(model)
    for n, p in params.items():
        g = grads[n] + wd * p.detach() if mask[n] else grads[n]
        ms = decay * 1.0 + (1.0 - decay) * g * g  # ms starts at ones
        expect = -(lr * g * torch.rsqrt(ms + eps))  # mom starts at zero; lr at count 0
        torch.testing.assert_close(tx.ms[n], ms, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(updates[n], expect, rtol=1e-6, atol=1e-8)
    assert tx.count == 1


def test_wd_and_frozen_masks():
    model = create_model("mnasnet0_35", device="cpu", num_classes=4)
    mask = wd_mask(model)
    names = [n for n, _ in model.named_parameters()]
    assert list(mask) == names
    decayed = {n for n, m in mask.items() if m}
    # Every conv weight (stem, depthwise, 1x1) and the classifier weight.
    assert "layers.0.weight" in decayed and "layers.3.weight" in decayed
    assert "layers.8.0.layers.3.weight" in decayed and "classifier.1.weight" in decayed
    # No BN weight or bias, nor the classifier bias.
    assert "layers.1.weight" not in decayed and "layers.1.bias" not in decayed
    assert "classifier.1.bias" not in decayed
    convs = sum(1 for n, p in model.named_parameters() if p.dim() == 4)
    assert len(decayed) == convs + 1
    frozen = backbone_frozen_mask(model)
    assert {n for n, f in frozen.items() if not f} == {"classifier.1.weight", "classifier.1.bias"}


@pytest.mark.parametrize("name,warmup", [("step", 0.0), ("cosine", 1.5), ("exp", 0.0),
                                         ("constant", 2.0), ("cosine", 0.0)])
def test_make_schedule_matches_jax(name, warmup):
    kw = dict(base_lr=0.4, steps_per_epoch=10, epochs=5, warmup_epochs=warmup,
              step_decay_epochs=2.0, exp_decay_epochs=1.2)
    ref = jax_make_schedule(name, **kw)
    ours = make_schedule(name, **kw)
    # The reference evaluates in fp32, the port in Python floats.
    for count in [0, 1, 5, 9, 10, 14, 15, 16, 23, 24, 25, 39, 49, 50, 60]:
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-5, abs=1e-9), count
    assert scale_lr_for_batch(0.016, 128) == pytest.approx(0.008)
