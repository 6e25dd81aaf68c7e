"""MNASNet-B1 depth-multiplier family in PyTorch.

Counterpart of ``mnasnet_tpu/models/mnasnet.py``. The module tree and the
parameter names are torchvision's (``layers.0`` .. ``layers.16``,
``classifier.1``), so a torchvision ``.pth`` loads with a strict
``load_state_dict``; ``convert/torch_converter.py`` maps the JAX package's
variables onto the same names.

Macro-architecture (MnasNet-B1, input 224x224x3):
  stem   Conv3x3 s2 -> d0
  sep    dw3x3 s1 + pw1x1 (linear) -> d1
  s1..s6 MBConv stacks: (k, s, expansion, repeats) =
         (3,2,3,3) (5,2,3,3) (5,2,6,3) (3,1,6,2) (5,2,6,4) (3,1,6,1)
         with out channels d2..d7
  head   Conv1x1 -> 1280, BN, ReLU; global mean; Dropout(0.2); Linear -> classes

Compute runs in ``dtype`` (bf16 or fp32) with fp32 parameters and running
stats. The head BN and ReLU and the pooled mean run in the compute dtype, as
in the reference; the classifier runs in fp32, where the reference's
``nn.Dense(dtype=...)`` multiplies in the compute dtype (ROADMAP Queue 3).

``dw_impl`` routes the depthwise work: ``"kernel"`` runs the hand-written
CUDA kernels (the reference's ``"pallas"``): the fused MBConv kernel for
every block that ``mbconv_fits_smem`` admits, else the fused dw kernel;
``"torch"`` runs plain PyTorch ops (the reference's ``"xla"``); ``"auto"``
is ``"kernel"`` on a CUDA tensor and ``"torch"`` elsewhere.

In train mode (``model.train()``) the forward is the reference's training
forward (``mnasnet.py:146-188, 317-350``): batch-statistic BN with the
running-stat EMA (``bn_stats``, ``bn_ema``, ``bn_momentum``), the
space-to-depth stem when ``stem_s2d``, and dropout before the classifier,
drawn from the ``generator`` that ``forward`` is given. ``bn_bwd`` routes the
backward of the BN+ReLU regions (stem, separable dw, head and each block's
expand and dw BN) as ``dw_impl`` routes the depthwise convs: ``"kernel"``
(the reference's ``"pallas_region"``) runs ``BatchNorm.relu_train_region``,
whose backward is the two CUDA kernels of ``ops/cuda/bn_bwd.py``; ``"torch"``
(the reference's ``"xla"``) leaves it to autograd; ``"auto"`` is
``"kernel"`` on a CUDA tensor. The BNs without a ReLU stay on autograd. The
fused MBConv kernel is inference-only and never runs in train mode.
``remat``, ``channel_pad`` and ``pw_lowering`` are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from mnasnet_tpu_torch.models.layers import (
    BN_MOMENTUM,
    BatchNorm,
    DepthwiseConv,
    PointwiseConv,
    StemConv,
    conv_kernel_init_,
    dense_kernel_init_,
    nchw,
    nhwc,
)
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fits_smem, mbconv_fused
from mnasnet_tpu_torch.ops.depthwise import (
    IMPLS,
    depthwise_conv_bn_relu_fused,
    resolve_impl,
)

# Base (alpha=1.0) widths and MBConv stack spec: (kernel, stride, expansion, repeats).
BASE_DEPTHS = (32, 16, 24, 40, 80, 96, 192, 320)
STACKS = ((3, 2, 3, 3), (5, 2, 3, 3), (5, 2, 6, 3), (3, 1, 6, 2), (5, 2, 6, 4), (3, 1, 6, 1))


def round_to_multiple_of(val: float, divisor: int = 8, round_up_bias: float = 0.9) -> int:
    """Round to the nearest multiple of ``divisor``, never below
    ``round_up_bias`` times the requested value."""
    new_val = max(divisor, int(val + divisor / 2) // divisor * divisor)
    return new_val if new_val >= round_up_bias * val else new_val + divisor


def get_depths(alpha: float) -> list[int]:
    return [round_to_multiple_of(d * alpha, 8) for d in BASE_DEPTHS]


def count_macs(alpha: float, image_size: int, num_classes: int = 1000) -> int:
    """Analytic per-image MAC count (314.4M at alpha=1.0, 224 px)."""
    d = get_depths(alpha)
    macs = 0
    hw = image_size // 2  # stem stride 2
    macs += 3 * 3 * 3 * d[0] * hw * hw          # stem conv
    macs += 3 * 3 * d[0] * hw * hw              # sep dw
    macs += d[0] * d[1] * hw * hw               # sep pw
    in_ch = d[1]
    for s, (k, stride, exp, repeats) in enumerate(STACKS):
        out_ch = d[2 + s]
        for j in range(repeats):
            st = stride if j == 0 else 1
            mid = in_ch * exp
            macs += in_ch * mid * hw * hw       # expand (pre-stride plane)
            hw_out = (hw + 2 * (k // 2) - k) // st + 1
            macs += k * k * mid * hw_out * hw_out   # dw
            macs += mid * out_ch * hw_out * hw_out  # project
            hw = hw_out
            in_ch = out_ch
    macs += in_ch * 1280 * hw * hw              # head conv
    macs += 1280 * num_classes                  # classifier
    return macs


def _bn_kw(bn_stats: str, bn_ema: str, bn_momentum: float) -> dict:
    return {"stats": bn_stats, "ema": bn_ema, "momentum": bn_momentum}


def _bn_relu(bn: BatchNorm, x: torch.Tensor, region: bool) -> torch.Tensor:
    """relu(bn(x)), with the region backward when ``region``."""
    return bn.relu_train_region(x) if region else torch.relu(bn(x))


class InvertedResidual(nn.Module):
    """MBConv block (torchvision's ``_InvertedResidual``).

    Input and output are NCHW tensors in channels_last memory.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 expansion: int, dw_impl: str = "auto", bn_stats: str = "one_pass",
                 bn_ema: str = "module", bn_momentum: float = BN_MOMENTUM,
                 bn_bwd: str = "auto"):
        super().__init__()
        mid = in_ch * expansion
        self.in_ch, self.mid_ch, self.out_ch = in_ch, mid, out_ch
        self.kernel_size = kernel_size
        self.stride = stride
        self.dw_impl = dw_impl
        self.bn_bwd = bn_bwd
        self.apply_residual = in_ch == out_ch and stride == 1
        kw = _bn_kw(bn_stats, bn_ema, bn_momentum)
        self.layers = nn.Sequential(
            PointwiseConv(in_ch, mid),
            BatchNorm(mid, **kw),
            nn.ReLU(),
            DepthwiseConv(mid, kernel_size, stride, dw_impl),
            BatchNorm(mid, **kw),
            nn.ReLU(),
            PointwiseConv(mid, out_ch),
            BatchNorm(out_ch, **kw),
        )

    def _use_fused_block(self, x: torch.Tensor, impl: str) -> bool:
        """The single-kernel fused block (ops/cuda/mbconv.py): eval mode only
        (``mnasnet.py:134``), on the kernel route, when the block has a
        shared-memory plan."""
        if self.training or impl != "kernel":
            return False
        return mbconv_fits_smem(
            x.shape[2], x.shape[3], self.in_ch, self.mid_ch, self.out_ch,
            self.kernel_size, self.stride, x.element_size())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        expand, expand_bn, _, dw, dw_bn, _, project, project_bn = self.layers
        impl = resolve_impl(self.dw_impl, x)
        if self._use_fused_block(x, impl):
            se, be = expand_bn.folded()
            sd, bd = dw_bn.folded()
            sp, bp = project_bn.folded()
            return nchw(mbconv_fused(
                nhwc(x), expand.matrix(), se, be, dw.kernel(), sd, bd,
                project.matrix(), sp, bp, kernel_size=self.kernel_size,
                stride=self.stride, residual=self.apply_residual))
        region = self.training and resolve_impl(self.bn_bwd, x) == "kernel"
        y = _bn_relu(expand_bn, expand(x), region)
        if not self.training and impl == "kernel":
            s, b = dw_bn.folded()
            y = nchw(depthwise_conv_bn_relu_fused(nhwc(y), dw.kernel(), s, b,
                                                  stride=self.stride, impl=impl))
        else:
            y = _bn_relu(dw_bn, dw(y), region)
        y = project_bn(project(y))  # linear bottleneck
        if self.apply_residual:
            y = y + x
        return y


def _stack(in_ch, out_ch, kernel_size, stride, expansion, repeats, **kw):
    blocks = [InvertedResidual(in_ch if j == 0 else out_ch, out_ch, kernel_size,
                               stride if j == 0 else 1, expansion, **kw)
              for j in range(repeats)]
    return nn.Sequential(*blocks)


class MNASNet(nn.Module):
    """MNASNet with depth multiplier ``alpha``.

    ``forward`` takes NCHW images (any memory format) and returns fp32 logits.
    ``seed`` seeds the ``torch.Generator`` of the weight init, which is the
    reference's (Kaiming-normal fan_out convs, Kaiming-uniform fan_out
    classifier, zero bias, unit BN). The module is built in eval mode.
    """

    def __init__(self, alpha: float, num_classes: int = 1000, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32, dw_impl: str = "auto", seed: int = 0,
                 bn_stats: str = "one_pass", bn_ema: str = "module",
                 bn_momentum: float = BN_MOMENTUM, stem_s2d: bool = False,
                 bn_bwd: str = "auto"):
        super().__init__()
        for knob, value in (("dw_impl", dw_impl), ("bn_bwd", bn_bwd)):
            if value not in IMPLS:
                raise ValueError(f"unknown {knob} {value!r}; choices: {IMPLS}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, not {dtype}")
        self.alpha = alpha
        self.num_classes = num_classes
        self.dtype = dtype
        self.dw_impl = dw_impl
        self.bn_bwd = bn_bwd
        self.bn_ema = bn_ema
        self.bn_momentum = bn_momentum
        kw = _bn_kw(bn_stats, bn_ema, bn_momentum)
        d = get_depths(alpha)
        stacks = []
        in_ch = d[1]
        for s, (k, stride, exp, repeats) in enumerate(STACKS):
            stacks.append(_stack(in_ch, d[2 + s], k, stride, exp, repeats, dw_impl=dw_impl,
                                 bn_stats=bn_stats, bn_ema=bn_ema, bn_momentum=bn_momentum,
                                 bn_bwd=bn_bwd))
            in_ch = d[2 + s]
        self.layers = nn.Sequential(
            StemConv(d[0], s2d=stem_s2d),
            BatchNorm(d[0], **kw),
            nn.ReLU(),
            DepthwiseConv(d[0], 3, 1, dw_impl),
            BatchNorm(d[0], **kw),
            nn.ReLU(),
            PointwiseConv(d[0], d[1]),
            BatchNorm(d[1], **kw),
            *stacks,
            PointwiseConv(d[7], 1280),
            BatchNorm(1280, **kw),
            nn.ReLU(),
        )
        self.classifier = nn.Sequential(nn.Dropout(p=dropout), nn.Linear(1280, num_classes))
        self._init_weights(seed)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (StemConv, DepthwiseConv, PointwiseConv)):
                conv_kernel_init_(m.weight, g)
            elif isinstance(m, nn.Linear):
                dense_kernel_init_(m.weight, g)
                nn.init.zeros_(m.bias)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Backbone up to the 1280-wide head feature map (pre-pool), NCHW."""
        L = self.layers
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        region = self.training and resolve_impl(self.bn_bwd, x) == "kernel"
        y = _bn_relu(L[1], L[0](x), region)
        if not self.training and resolve_impl(self.dw_impl, y) == "kernel":
            s, b = L[4].folded()
            y = nchw(depthwise_conv_bn_relu_fused(nhwc(y), L[3].kernel(), s, b,
                                                  stride=1, impl="kernel"))
        else:
            y = _bn_relu(L[4], L[3](y), region)
        y = L[7](L[6](y))
        for stack in L[8:14]:
            y = stack(y)
        return _bn_relu(L[15], L[14](y), region)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """fp32 logits. In train mode dropout draws from ``generator`` (the
        default generator of the device when None)."""
        y = self.features(x).mean(dim=(2, 3))  # global average pool, compute dtype
        p = self.classifier[0].p
        if self.training and p > 0.0:
            keep = torch.rand(y.shape, device=y.device, generator=generator) < 1.0 - p
            y = torch.where(keep, y / (1.0 - p), torch.zeros_like(y))
        # The classifier runs in fp32.
        return self.classifier[1](y.float())


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA on a machine without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _ctor(alpha: float):
    def make(num_classes: int = 1000, dropout: float = 0.2, **kwargs) -> MNASNet:
        return MNASNet(alpha=alpha, num_classes=num_classes, dropout=dropout, **kwargs)

    make.__name__ = f"mnasnet{str(alpha).replace('.', '_')}"
    make.__doc__ = f"MNASNet with depth multiplier {alpha}."
    return make


mnasnet0_35 = _ctor(0.35)
mnasnet0_5 = _ctor(0.5)
mnasnet0_75 = _ctor(0.75)
mnasnet1_0 = _ctor(1.0)
mnasnet1_3 = _ctor(1.3)
mnasnet1_4 = _ctor(1.4)

MODEL_REGISTRY = {
    "mnasnet0_35": mnasnet0_35,
    "mnasnet0_5": mnasnet0_5,
    "mnasnet0_75": mnasnet0_75,
    "mnasnet1_0": mnasnet1_0,
    "mnasnet1_3": mnasnet1_3,
    "mnasnet1_4": mnasnet1_4,
}


def arch_alpha(name: str) -> float:
    """The depth multiplier of a registry name or any ``mnasnet<int>_<frac>``."""
    if name.startswith("mnasnet"):
        parts = name[len("mnasnet"):].split("_")
        if len(parts) == 2 and all(p.isdigit() for p in parts):
            return float(f"{parts[0]}.{parts[1]}")
    raise ValueError(
        f"unknown arch {name!r}; choices: {sorted(MODEL_REGISTRY)} "
        "or any mnasnet<int>_<frac> multiplier spelling"
    )


def create_model(name: str, *, device="cuda", **kwargs) -> MNASNet:
    """Build a model by arch name, in eval mode, on ``device``.

    Registry names cover the reference ctor set plus 1.4; any other
    ``mnasnet<int>_<frac>`` spelling (e.g. ``mnasnet0_9``) builds that depth
    multiplier. ``kwargs`` go to :class:`MNASNet` (``num_classes``,
    ``dropout``, ``dtype``, ``dw_impl``, ``seed``, and the training knobs
    ``bn_stats``, ``bn_ema``, ``bn_momentum``, ``stem_s2d``, ``bn_bwd``). The
    weights are made on the CPU from ``seed`` and moved, so a seed gives the
    same weights on every device. ``device="cuda"`` without a card raises.
    """
    dev = resolve_device(device)
    if name in MODEL_REGISTRY:
        model = MODEL_REGISTRY[name](**kwargs)
    else:
        model = MNASNet(alpha=arch_alpha(name), **kwargs)
    return model.to(dev)
