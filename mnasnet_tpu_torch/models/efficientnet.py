"""EfficientNet (v1) in PyTorch, on the port's layers and kernels.

EfficientNet-B0 comes out of MnasNet's search space (Tan & Le,
arXiv:1905.11946); the family scales it in width, depth and resolution. The
module tree and the parameter names are torchvision's ``efficientnet_b*``
(``features.0`` .. ``features.8``, ``features.i.j.block.k``, the
squeeze-and-excitation's ``block.k.fc1`` / ``fc2``, ``classifier.1``), so
a torchvision ``.pth`` loads with a strict ``load_state_dict``.

Macro-architecture (B0's stage table, each stage ``(expansion, k, stride,
in, out, repeats)``; widths times ``width_mult`` and rounded as torchvision
rounds them, :func:`~mnasnet_tpu_torch.models.mnasnet.round_to_multiple_of`;
repeats ``ceil(depth_mult * repeats)``):
  stem   conv3x3 s2 -> 32, BN, SiLU
  blocks MBConv: [conv1x1 -> e*Cin, BN, SiLU] (no expand conv where e = 1),
         dw kxk (stride on the stage's first), BN, SiLU, squeeze-and-excitation
         (mean over H, W; 1x1 conv with bias to max(1, Cin/4), SiLU; 1x1 conv
         with bias back, sigmoid; the plane scaled), conv1x1 -> Cout, BN, and
         where Cin == Cout and the stride is 1, stochastic depth and the input
  head   conv1x1 -> 4 * last width, BN, SiLU; mean; Dropout; Linear
Block i of the n blocks drops its residual branch with probability
``stochastic_depth * i / n`` (torchvision's row mode: per image, the kept
ones scaled by 1 / (1 - p)).

Compute runs in ``dtype`` (bf16 or fp32) with fp32 parameters, as
:class:`~mnasnet_tpu_torch.models.mnasnet.MNASNet`; the same ``dw_impl``
and ``bn_bwd`` routes. In train mode every BN+SiLU region (stem, each
expand and dw BN, head) runs ``BatchNorm.relu_train_region(x, "silu")`` on
the ``"kernel"`` route: the region kernels' SiLU instantiations
(``ops/cuda/bn_bwd.py``); the project BNs are linear and stay on autograd;
the squeeze-and-excitation is plain PyTorch (``layers.SqueezeExcitation``).
In eval mode BN is folded, the dw kernel takes its SiLU epilogue, and no
block takes the fused MBConv kernel (its single pass cannot wait for the
whole plane's pooled gate before the project conv).

The random draws of a train step are one mask (:meth:`EfficientNet.
dropout_keep`): ``rows x (head width + residual blocks)`` from one uniform
draw, each column against its keep probability (the classifier dropout's,
then each residual block's ``1 - p``), so that a step draws once for its
global batch and hands each shard and microbatch its rows, as for MNASNet.

Not supported for this model, each refused with an error: ``remat``,
``channel_pad``, and replica handles on its BatchNorms (sync-BN and the
spatial mesh).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mnasnet_tpu_torch.models.layers import (
    BatchNorm,
    DepthwiseConv,
    PointwiseConv,
    SqueezeExcitation,
    StemConv,
    conv_kernel_init_,
    dense_kernel_init_,
    nchw,
    nhwc,
    replicas_of,
)
from mnasnet_tpu_torch.models.mnasnet import resolve_device, round_to_multiple_of
from mnasnet_tpu_torch.ops.depthwise import (
    BN_BWD_IMPLS,
    IMPLS,
    depthwise_conv_bn_relu_fused,
    resolve_impl,
)
from mnasnet_tpu_torch.utils.profiling import span

# EfficientNet-B0's stages: (expansion, kernel, stride, in, out, repeats).
B0_STAGES = ((1, 3, 1, 32, 16, 1), (6, 3, 2, 16, 24, 2), (6, 5, 2, 24, 40, 2),
             (6, 3, 2, 40, 80, 3), (6, 5, 1, 80, 112, 3), (6, 5, 2, 112, 192, 4),
             (6, 3, 1, 192, 320, 1))
B0_STEM = 32
# The paper's TF recipe: BN epsilon 1e-3 and EMA decay 0.99 (torchvision's
# modules default to 1e-5 and 0.9 for B0-B4).
EFFNET_BN_EPSILON = 1e-3
EFFNET_BN_MOMENTUM = 0.99
SE_RATIO = 0.25
# (width_mult, depth_mult, resolution, dropout) of the published models.
VARIANTS = {
    "efficientnet_b0": (1.0, 1.0, 224, 0.2),
    "efficientnet_b4": (1.4, 1.8, 380, 0.4),
}


def stage_table(width_mult: float, depth_mult: float) -> list[tuple[int, int, int, int, int, int]]:
    """B0's stages scaled: (expansion, k, stride, in, out, repeats) with the
    widths rounded to multiples of 8 and the repeats ``ceil(d * r)``."""
    return [(e, k, s, round_to_multiple_of(cin * width_mult, 8),
             round_to_multiple_of(cout * width_mult, 8), int(math.ceil(r * depth_mult)))
            for e, k, s, cin, cout, r in B0_STAGES]


def _bn_act(bn: BatchNorm, x: torch.Tensor, region: bool) -> torch.Tensor:
    """silu(bn(x)), on the region kernels when ``region``."""
    return bn.relu_train_region(x, "silu") if region else F.silu(bn(x))


class MBConv(nn.Module):
    """torchvision's ``MBConv``: ``block`` holds [expand], dw, SE, project,
    each a Sequential of conv, BN [, SiLU] (or the SE module), so that its
    names are torchvision's. ``column``: the block's column of the step's
    random mask (after the classifier dropout's) and ``drop`` its drop
    probability, for a residual block."""

    def __init__(self, cin: int, cout: int, expansion: int, kernel_size: int, stride: int,
                 drop: float, column: int | None, dw_impl: str, bn_kw: dict,
                 pw_lowering: str):
        super().__init__()
        mid = round_to_multiple_of(cin * expansion, 8)
        self.expand = expansion != 1
        self.stride = stride
        self.residual = stride == 1 and cin == cout
        self.drop, self.column = drop, column
        layers = []
        if self.expand:
            layers.append(nn.Sequential(PointwiseConv(cin, mid, pw_lowering),
                                        BatchNorm(mid, **bn_kw), nn.SiLU()))
        layers += [nn.Sequential(DepthwiseConv(mid, kernel_size, stride, dw_impl),
                                 BatchNorm(mid, **bn_kw), nn.SiLU()),
                   SqueezeExcitation(mid, max(1, int(cin * SE_RATIO))),
                   nn.Sequential(PointwiseConv(mid, cout, pw_lowering), BatchNorm(cout, **bn_kw))]
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None, region: bool,
                impl: str) -> torch.Tensor:
        parts = list(self.block)
        y = x
        if self.expand:
            conv, bn, _ = parts.pop(0)
            y = _bn_act(bn, conv(y), region) if self.training else F.silu(bn(conv(y)))
        (dw, dw_bn, _), se, (project, project_bn) = parts
        if self.training:
            y = _bn_act(dw_bn, dw(y), region)
        elif impl != "torch":
            s, b = dw_bn.folded()
            y = dw.on_band(y, lambda yw: depthwise_conv_bn_relu_fused(
                yw, dw.kernel(), s, b, stride=self.stride, relu=False, silu=True, impl=impl))
        else:
            y = F.silu(dw_bn(dw(y)))
        y = project_bn(project(se(y)))
        if not self.residual:
            return y
        if self.training and keep is not None and self.drop > 0.0:
            with span("mnasnet.model.drop_path"):
                scale = (keep[:, self.column].float() / (1.0 - self.drop)).to(y.dtype)
                y = nchw(nhwc(y) * scale.view(-1, 1, 1, 1))
        return y + x


class EfficientNet(nn.Module):
    """EfficientNet with width ``width_mult`` and depth ``depth_mult``.

    ``forward`` takes NCHW images (any memory format) and returns fp32
    logits. ``seed`` seeds the weight init (Kaiming-normal fan_out convs,
    Kaiming-uniform fan_out classifier, zero biases, unit BN). The module is
    built in eval mode. The knobs are :class:`MNASNet`'s (``dtype``,
    ``dw_impl``, ``bn_bwd``, ``bn_stats``, ``bn_ema``, ``bn_momentum``,
    ``stem_s2d``, ``pw_lowering``), with the recipe's BN epsilon
    ``bn_eps``; ``stochastic_depth`` is the last block's drop probability.
    ``remat`` and ``channel_pad`` other than their defaults raise.
    """

    def __init__(self, width_mult: float, depth_mult: float, num_classes: int = 1000,
                 dropout: float = 0.2, stochastic_depth: float = 0.2,
                 dtype: torch.dtype = torch.float32, dw_impl: str = "auto", seed: int = 0,
                 bn_stats: str = "one_pass", bn_ema: str = "module",
                 bn_momentum: float = EFFNET_BN_MOMENTUM, bn_eps: float = EFFNET_BN_EPSILON,
                 stem_s2d: bool = False, bn_bwd: str = "auto", remat: bool = False,
                 pw_lowering: str = "auto", channel_pad: int = 1):
        super().__init__()
        for knob, value, choices in (("dw_impl", dw_impl, IMPLS),
                                     ("bn_bwd", bn_bwd, BN_BWD_IMPLS)):
            if value not in choices:
                raise ValueError(f"unknown {knob} {value!r}; choices: {choices}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, not {dtype}")
        if remat:
            raise ValueError("remat is not supported for EfficientNet")
        if channel_pad != 1:
            raise ValueError("channel_pad is not supported for EfficientNet")
        self.num_classes = num_classes
        self.dtype = dtype
        self.dw_impl, self.bn_bwd = dw_impl, bn_bwd
        self.bn_ema, self.bn_momentum = bn_ema, bn_momentum
        kw = {"eps": bn_eps, "momentum": bn_momentum, "stats": bn_stats, "ema": bn_ema}
        table = stage_table(width_mult, depth_mult)
        total = sum(r for *_, r in table)
        stem = round_to_multiple_of(B0_STEM * width_mult, 8)
        last = table[-1][4]
        self.head_width = 4 * last
        stages, index, drops = [], 0, []
        for e, k, s, cin, cout, repeats in table:
            blocks = []
            for j in range(repeats):
                cin_j, s_j = (cin, s) if j == 0 else (cout, 1)
                drop = stochastic_depth * index / total
                column = None
                if s_j == 1 and cin_j == cout:
                    column = self.head_width + len(drops)
                    drops.append(drop)
                blocks.append(MBConv(cin_j, cout, e, k, s_j, drop, column, dw_impl, kw,
                                     pw_lowering))
                index += 1
            stages.append(nn.Sequential(*blocks))
        self.features = nn.Sequential(
            nn.Sequential(StemConv(stem, s2d=stem_s2d), BatchNorm(stem, **kw), nn.SiLU()),
            *stages,
            nn.Sequential(PointwiseConv(last, self.head_width), BatchNorm(self.head_width, **kw),
                          nn.SiLU()),
        )
        self.classifier = nn.Sequential(nn.Dropout(p=dropout), nn.Linear(self.head_width,
                                                                         num_classes))
        self.drops = drops
        # Each column's keep probability: the classifier dropout's, then each
        # residual block's; on the model's device, so a captured step reads it.
        self.register_buffer("keep_prob", torch.tensor(
            [1.0 - dropout] * self.head_width + [1.0 - p for p in drops]), persistent=False)
        self._init_weights(seed)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (StemConv, DepthwiseConv, PointwiseConv)):
                conv_kernel_init_(m.weight, g)
            elif isinstance(m, SqueezeExcitation):
                for fc in (m.fc1, m.fc2):
                    conv_kernel_init_(fc.weight, g)
                    nn.init.zeros_(fc.bias)
            elif isinstance(m, nn.Linear):
                dense_kernel_init_(m.weight, g)
                nn.init.zeros_(m.bias)

    def blocks(self) -> list[MBConv]:
        return [b for stage in self.features[1:-1] for b in stage]

    def dropout_keep(self, rows: int, generator: torch.Generator | None,
                     device) -> torch.Tensor | None:
        """The train-mode random mask of ``rows`` images (bool, true where
        kept): the classifier dropout's ``head_width`` columns, then one
        column for each residual block's stochastic depth, from one uniform
        draw of ``rows x columns`` against each column's keep probability;
        None when nothing is dropped."""
        if self.classifier[0].p <= 0.0 and not any(p > 0.0 for p in self.drops):
            return None
        u = torch.rand((rows, self.keep_prob.numel()), device=device, generator=generator)
        return u < self.keep_prob.to(u.device)

    def features_of(self, x: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
        """Backbone up to the head's feature map (pre-pool), NCHW."""
        if replicas_of(self) is not None:
            raise ValueError("EfficientNet takes no replica handle on its BatchNorms: sync-BN "
                             "and the spatial mesh are not supported for it")
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        impl = resolve_impl(self.dw_impl, x)
        region = self.training and resolve_impl(self.bn_bwd, x) == "kernel"
        stem, *_, head = self.features
        if self.training:
            y = _bn_act(stem[1], stem[0](x), region)
        else:
            y = F.silu(stem[1](stem[0](x)))
        for block in self.blocks():
            y = block(y, keep, region, impl)
        if self.training:
            return _bn_act(head[1], head[0](y), region)
        return F.silu(head[1](head[0](y)))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """fp32 logits. In train mode the classifier dropout and the blocks'
        stochastic depth keep what ``keep`` marks, or draw that mask from
        ``generator`` (the device's default generator when None) when
        ``keep`` is None."""
        if self.training and keep is None:
            keep = self.dropout_keep(x.shape[0], generator, x.device)
        y = self.features_of(x, keep if self.training else None).mean(dim=(2, 3))
        p = self.classifier[0].p
        if self.training and keep is not None and p > 0.0:
            y = torch.where(keep[:, :self.head_width], y / (1.0 - p), torch.zeros_like(y))
        return self.classify(y)

    def classify(self, pooled: torch.Tensor) -> torch.Tensor:
        """fp32 logits of pooled features, the classifier in the compute
        dtype (as :meth:`MNASNet.classify`)."""
        fc = self.classifier[1]
        y = F.linear(pooled.to(self.dtype), fc.weight.to(self.dtype))
        return (y + fc.bias.to(self.dtype)).float()


def _ctor(name: str):
    width, depth, _size, dropout = VARIANTS[name]

    def make(num_classes: int = 1000, dropout: float = dropout, width_mult: float = width,
             depth_mult: float = depth, **kwargs) -> EfficientNet:
        return EfficientNet(width_mult, depth_mult, num_classes=num_classes, dropout=dropout,
                            **kwargs)

    make.__name__ = name
    make.__doc__ = f"EfficientNet with width {width} and depth {depth} ({_size} px)."
    return make


efficientnet_b0 = _ctor("efficientnet_b0")
efficientnet_b4 = _ctor("efficientnet_b4")

EFFICIENTNET_REGISTRY = {"efficientnet_b0": efficientnet_b0, "efficientnet_b4": efficientnet_b4}


def create_efficientnet(name: str, *, device="cuda", **kwargs) -> EfficientNet:
    """An EfficientNet of :data:`EFFICIENTNET_REGISTRY` in eval mode on
    ``device``, its weights made on the CPU from ``seed``."""
    dev = resolve_device(device)
    return EFFICIENTNET_REGISTRY[name](**kwargs).to(dev)
