"""Core layers of the PyTorch MNASNet family.

Counterpart of ``mnasnet_tpu/models/layers.py``. Parameter and buffer names
follow torchvision's MNASNet state_dict (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so a torchvision
``.pth`` loads with a strict ``load_state_dict``.

Layout: every module takes and returns NCHW tensors in ``torch.channels_last``
memory. In that layout ``x.permute(0, 2, 3, 1)`` (:func:`nhwc`) is a
contiguous NHWC tensor without a copy; the 1x1 convs run as a matmul over
that view (or as a 1x1 conv, :class:`PointwiseConv`), and the kernels in
``ops/cuda`` take it as they are.

In train mode BatchNorm normalises with batch statistics and updates its
running statistics (:class:`BatchNorm`), and the stem may take its
space-to-depth form (:class:`StemConv`). A BatchNorm that holds a replica
handle (:func:`set_replicas`) takes the statistics of the global batch over
the data-parallel replicas: sync-BN.

Under a spatial mesh (``parallel/mesh.py``) each module sees its rank's band
of rows of a plane. The stem and the depthwise convs, which hold the handle
too, run on the band's window of rows with the halo rows of the other ranks
(``parallel/spatial.py:banded``); a BatchNorm's sums are world-wide and its
count is the band plan's (``parallel/dist.py:global_rows``); a 1x1 conv needs
no halo.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mnasnet_tpu_torch.ops.cuda.bn_bwd import STATS, batch_moments, bn_relu_train
from mnasnet_tpu_torch.ops.cuda.se import squeeze_excitation
from mnasnet_tpu_torch.ops.depthwise import depthwise_conv2d
from mnasnet_tpu_torch.parallel.dist import Replicas, global_rows
from mnasnet_tpu_torch.parallel.mesh import spatial_of
from mnasnet_tpu_torch.parallel.spatial import banded
from mnasnet_tpu_torch.utils.profiling import span

BN_MOMENTUM = 0.9997  # EMA decay; torch momentum = 1 - 0.9997 = 3e-4
BN_EPSILON = 1e-5
BN_EMA = ("module", "external")
PW_LOWERINGS = ("auto", "conv", "dot")
# The lowering ``pw_lowering="auto"`` takes in each mode, measured on an
# NVIDIA H100 80GB HBM3 at 700 W (``python3 chip_smoke.py --only knobs``,
# PERF.md §6): in training conv led dot in each of 8 alternating
# pairs, by 0.28 ms (median; 0.8% of a 36.7 ms step), while fresh builds of
# one lowering spread by 0.41-1.08 ms within a call; serving on the kernel
# route, the fused blocks run no separate 1x1 conv. Within noise in both
# modes, so both keep dot, the port's lowering before. The reference's
# mapping (conv when training, dot when serving) was measured on its TPU.
PW_AUTO = {"train": "dot", "eval": "dot"}


def conv_kernel_init_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Kaiming-normal, fan_out, relu: the reference's Conv2d init."""
    return nn.init.kaiming_normal_(weight, mode="fan_out", nonlinearity="relu",
                                   generator=generator)


def dense_kernel_init_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Kaiming-uniform, fan_out, sigmoid gain: the reference's final Linear init."""
    return nn.init.kaiming_uniform_(weight, mode="fan_out", nonlinearity="sigmoid",
                                    generator=generator)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def nchw(y: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``y`` is contiguous)."""
    return y.permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    """BatchNorm2d with torchvision's names, the reference's running-stat
    semantics and BN folding (``mnasnet_tpu/models/layers.py:150-271``).

    Eval mode normalises with the running statistics: the factors
    ``inv = γ·rsqrt(σ²+ε)`` and ``shift = β − μ·inv`` are computed in fp32 and
    applied in the activation's dtype. Train mode normalises with the batch
    mean and *biased* variance (``stats``: ``"one_pass"`` max(E[x²]−E[x]², 0)
    or ``"two_pass"`` E[(x−μ)²], in fp32) and updates the running variance
    with the *Bessel-corrected* one. ``ema="module"`` updates
    ``r = momentum·r + (1−momentum)·b`` here; ``ema="external"`` stores the raw
    batch statistics and leaves the EMA to the train step
    (``train/steps.py:fused_ema_stats``). The updates run under
    ``torch.no_grad``; ``num_batches_tracked`` counts train forwards and
    changes no arithmetic.

    ``replicas`` (None: this process's batch alone) makes it sync-BN
    (``mnasnet_tpu/models/layers.py:13-16``): the moments are summed over the
    replicas with a differentiable all-reduce, and Bessel's correction takes
    the global count. The handle is not part of the state_dict.
    """

    def __init__(self, features: int, eps: float = BN_EPSILON, momentum: float = BN_MOMENTUM,
                 stats: str = "one_pass", ema: str = "module"):
        super().__init__()
        if stats not in STATS:
            raise ValueError(f"unknown BN stats {stats!r}; choices: {STATS}")
        if ema not in BN_EMA:
            raise ValueError(f"unknown BN ema {ema!r}; choices: {BN_EMA}")
        self.num_features = features
        self.eps = eps
        self.momentum = momentum
        self.stats = stats
        self.ema = ema
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.replicas: Replicas | None = None

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Inference-time folded (scale, bias) in fp32: ``y = x*scale + bias``."""
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        return inv, self.bias - self.running_mean * inv

    @torch.no_grad()
    def update_stats(self, rows: int, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The running-statistics update of one train forward whose batch
        moments were ``mean`` and ``var`` over ``rows`` rows per channel on
        this replica. Under sync-BN the global count comes from
        :func:`~mnasnet_tpu_torch.parallel.global_rows`, which reads nothing
        on the host once the step's eager warm-up has seen ``rows``, so a
        CUDA graph captures this update."""
        n = global_rows(rows, self.replicas)
        bessel = n / max(n - 1, 1)
        if self.ema == "external":
            self.running_mean.copy_(mean)
            self.running_var.copy_(var * bessel)
        else:
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var * bessel)
        self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = self.train_forward(x)
            self.update_stats(rows(x), mean, var)
            return y
        inv, shift = self.folded()
        return _affine(x, inv, shift)

    def train_forward(self, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Train-mode BN with the batch statistics, without the running-stat
        update: (y, mean, biased var). The caller applies
        :meth:`update_stats` (a rematerialised block does so outside its
        checkpointed region, once per forward)."""
        mean, var = batch_moments(nhwc(x), self.stats, self.replicas)
        inv = self.weight * torch.rsqrt(var + self.eps)
        return _affine(x, inv, self.bias - mean * inv), mean, var

    def relu_train_forward(self, x: torch.Tensor, act: str = "relu"
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Train-mode BN + ReLU (or SiLU: ``act="silu"``) with the region
        forward and backward of ``ops/cuda/bn_bwd.py`` (CUDA kernels, or their
        plain versions on the CPU), without the running-stat update: (y, mean,
        biased var). The forward is that of ``relu(self(x))`` (``silu``);
        only the backward differs."""
        y, mean, var = bn_relu_train(nhwc(x), self.weight, self.bias, self.eps, self.stats,
                                     self.replicas, act)
        return nchw(y), mean, var

    def relu_train_region(self, x: torch.Tensor, act: str = "relu") -> torch.Tensor:
        """:meth:`relu_train_forward` with the running-stat update."""
        y, mean, var = self.relu_train_forward(x, act)
        self.update_stats(rows(x), mean, var)
        return y


def rows(x: torch.Tensor) -> int:
    """Rows per channel of an NCHW tensor: N·H·W."""
    return x.numel() // x.shape[1]


def _affine(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x·inv + shift per channel of NCHW x, the fp32 factors cast to x's dtype."""
    dt = x.dtype
    return x * inv.to(dt).view(1, -1, 1, 1) + shift.to(dt).view(1, -1, 1, 1)


def set_replicas(module: nn.Module, replicas: Replicas | None) -> Replicas | None:
    """Give every :class:`BatchNorm` in ``module`` the replica handle (sync-BN;
    None: per-replica statistics), and every :class:`StemConv` and
    :class:`DepthwiseConv` too (their halo rows under a spatial mesh);
    returns the handle the BatchNorms held before."""
    previous = replicas_of(module)
    for m in module.modules():
        if isinstance(m, (BatchNorm, StemConv, DepthwiseConv)):
            m.replicas = replicas
    return previous


def replicas_of(module: nn.Module) -> Replicas | None:
    """The replica handle the BatchNorms of ``module`` hold; raises when they
    hold different ones."""
    handles = {id(m.replicas): m.replicas for m in module.modules() if isinstance(m, BatchNorm)}
    if len(handles) > 1:
        raise ValueError("the BatchNorms of the module hold different replica handles")
    return next(iter(handles.values()), None)


class PointwiseConv(nn.Module):
    """Bias-free 1x1 conv (``layers.py:43-88``) with the reference's
    ``lowering``: ``"dot"`` a matmul over the NHWC view, ``"conv"`` a 1x1
    ``F.conv2d`` on the channels_last tensor (cuDNN on the card), ``"auto"``
    the lowering :data:`PW_AUTO` gives the module's mode. The parameter is
    the same under every lowering, so state_dicts do not depend on it. In
    fp32 on the card the two follow different TF32 flags:
    ``torch.backends.cuda.matmul.allow_tf32`` (off by default) for dot,
    ``torch.backends.cudnn.allow_tf32`` (on by default) for conv."""

    def __init__(self, in_ch: int, out_ch: int, lowering: str = "dot"):
        super().__init__()
        if lowering not in PW_LOWERINGS:
            raise ValueError(f"unknown pw_lowering {lowering!r}; choices: {PW_LOWERINGS}")
        self.lowering = lowering
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1))

    def matrix(self) -> torch.Tensor:
        """(Cin, Cout) view, the JAX package's layout."""
        return self.weight[:, :, 0, 0].t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lowering = self.lowering
        if lowering == "auto":
            lowering = PW_AUTO["train" if self.training else "eval"]
        if lowering == "conv":
            y = F.conv2d(x, self.weight.to(x.dtype))
            return y.contiguous(memory_format=torch.channels_last)
        return nchw(torch.matmul(nhwc(x), self.matrix().to(x.dtype)))


class StemConv(nn.Module):
    """The 3x3 stride-2 RGB stem conv, bias-free, with the reference's
    space-to-depth form (``layers.py:94-147``) for training.

    With ``s2d=True``, in train mode and at even H and W, each 2x2 pixel
    block is packed into channels ((H, W, 3) -> (H/2, W/2, 12)) and an
    exactly equivalent 2x2 stride-1 conv runs on it. Its kernel is the
    (F, 3, 3, 3) parameter padded and regrouped on every call, so the
    gradient lands on the parameter. Eval mode runs the plain conv.

    Under a spatial mesh x is the rank's band of image rows: either form
    runs on the band's window (``parallel/spatial.py:banded``), whose start
    is even, so that the s2d form packs whole pixel blocks: the two image
    rows above the band's first block come from the rank above (the first
    of them meets only the zero tap), and the zero row on top is the
    window's, cropped away, except on the first band.
    """

    def __init__(self, features: int, s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        self.weight = nn.Parameter(torch.empty(features, 3, 3, 3))
        self.replicas: Replicas | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s2d = self.s2d and self.training
        if spatial_of(self.replicas) is None:
            return self._conv(x, s2d)
        return nchw(banded(nhwc(x), self.replicas, 3, 2, lambda xw: nhwc(self._conv(nchw(xw), s2d)),
                           self.weight.shape[0], (self.weight,)))

    def _conv(self, x: torch.Tensor, s2d: bool) -> torch.Tensor:
        n, c, h, w = x.shape
        if not s2d or h % 2 or w % 2:
            return F.conv2d(x, self.weight.to(x.dtype), stride=2, padding=1)
        xs = (nhwc(x).reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
              .reshape(n, h // 2, w // 2, 4 * c))
        # Output (i, j) sums taps u, v in {-1, 0, 1} of x[2i+u, 2j+v]; in s2d
        # space that window is rows {i-1, i} x cols {j-1, j} with
        # u = 2A + dy - 2: pad the kernel's top-left so that (A=0, dy=0) is
        # the zero tap, then regroup (2A + dy) -> (A, dy).
        k = F.pad(self.weight.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))  # HWIO (4,4,C,F)
        f = k.shape[-1]
        k = k.reshape(2, 2, 2, 2, c, f).permute(0, 2, 1, 3, 4, 5).reshape(2, 2, 4 * c, f)
        xs = F.pad(xs, (0, 0, 1, 0, 1, 0))  # one zero row on top, one column on the left
        return F.conv2d(nchw(xs), k.permute(3, 2, 0, 1).to(x.dtype))


class DepthwiseConv(nn.Module):
    """Bias-free depthwise k x k conv with padding k//2; the weight keeps
    torch's (C, 1, k, k) layout. ``impl`` picks the route of
    :func:`mnasnet_tpu_torch.ops.depthwise.depthwise_conv2d`."""

    def __init__(self, channels: int, kernel_size: int, stride: int, impl: str = "auto"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size, kernel_size))
        self.replicas: Replicas | None = None

    def kernel(self) -> torch.Tensor:
        """(k, k, 1, C) view, the JAX package's layout."""
        return self.weight.permute(2, 3, 1, 0)

    def on_band(self, x: torch.Tensor, fn, out_channels: int | None = None) -> torch.Tensor:
        """``fn`` (NHWC, this conv's geometry, ``out_channels`` out, by default
        this conv's) on NCHW ``x``: on the whole plane, or under a spatial
        mesh on the band's window of rows (``parallel/spatial.py:banded``);
        NCHW out."""
        y = nhwc(x)
        if spatial_of(self.replicas) is not None:
            return nchw(banded(y, self.replicas, self.kernel_size, self.stride, fn,
                               out_channels or self.weight.shape[0], (self.weight,)))
        return nchw(fn(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.on_band(x, lambda y: depthwise_conv2d(y, self.kernel(), stride=self.stride,
                                                          impl=self.impl))


class BiasedPointwiseConv(nn.Module):
    """A 1x1 conv with a bias on pooled features (N, Cin) -> (N, Cout): the
    squeeze-and-excitation block's ``fc1`` and ``fc2`` (torchvision's
    ``nn.Conv2d(cin, cout, 1)``, so its ``weight`` is (Cout, Cin, 1, 1)),
    computed as a linear layer in the features' dtype."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        return F.linear(s, self.weight[:, :, 0, 0].to(s.dtype), self.bias.to(s.dtype))


class SqueezeExcitation(nn.Module):
    """torchvision's ``SqueezeExcitation`` with SiLU (EfficientNet): the
    plane's mean over H and W, ``fc1`` to ``squeeze`` channels, SiLU, ``fc2``
    back, sigmoid, and the plane scaled by that gate, all in x's dtype (span
    ``mnasnet.model.se``). NCHW channels_last in and out.

    ``kernels``, which the owning block sets to its route before each call:
    True takes the SE ops (``ops/cuda/se.py:squeeze_excitation``: the pool,
    the scale and, in the backward, the gate gradient and the fused dx pass
    on the kernels, the MLP on torch ops); False, plain PyTorch ops."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = BiasedPointwiseConv(channels, squeeze)
        self.fc2 = BiasedPointwiseConv(squeeze, channels)
        self.kernels = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("mnasnet.model.se"):
            y = nhwc(x)
            if self.kernels:
                return nchw(squeeze_excitation(y, self.fc1.weight, self.fc1.bias,
                                               self.fc2.weight, self.fc2.bias))
            gate = torch.sigmoid(self.fc2(F.silu(self.fc1(y.mean(dim=(1, 2))))))
            return nchw(y * gate[:, None, None, :])
