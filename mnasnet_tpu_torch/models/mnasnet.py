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
stats. The head BN and ReLU, the pooled mean and the classifier run in the
compute dtype, as in the reference, whose ``nn.Dense(dtype=...)`` casts its
input, kernel and bias to that dtype, rounds the product and the bias sum to
it, and only then casts the logits to fp32.

``dw_impl`` routes the depthwise work: ``"kernel"`` runs the hand-written
CUDA kernels (the reference's ``"pallas"``): the fused MBConv kernel for
every block that ``mbconv_fits_smem`` admits, else the fused dw kernel;
``"torch"`` runs plain PyTorch ops (the reference's ``"xla"``); ``"auto"``
is ``"kernel"`` on a CUDA tensor and ``"torch"`` elsewhere.

In train mode (``model.train()``) the forward is the reference's training
forward (``mnasnet.py:146-188, 317-350``): batch-statistic BN with the
running-stat EMA (``bn_stats``, ``bn_ema``, ``bn_momentum``), the
space-to-depth stem when ``stem_s2d``, and dropout before the classifier,
drawn from the ``generator`` that ``forward`` is given, or given as a mask
(:meth:`MNASNet.dropout_keep`: a train step draws one mask for its whole
global batch and hands each shard its rows). ``bn_bwd`` routes the
backward of the BN+ReLU regions (stem, separable dw, head and each block's
expand and dw BN) as ``dw_impl`` routes the depthwise convs: ``"kernel"``
(the reference's ``"pallas_region"``) runs ``BatchNorm.relu_train_region``,
whose backward is the two CUDA kernels of ``ops/cuda/bn_bwd.py``; ``"torch"``
(the reference's ``"xla"``) leaves it to autograd; ``"auto"`` is
``"kernel"`` on a CUDA tensor. The BNs without a ReLU stay on autograd. The
fused MBConv kernel is inference-only and never runs in train mode.
The reference's model knobs ``remat``, ``pw_lowering`` and ``channel_pad``
are :class:`MNASNet`'s; ``dw_impl`` also takes its training routes
``"taps"``, ``"taps2"`` and ``"hybrid"`` (``ops/depthwise.py``).

Under a spatial mesh (the replica handle of ``models.layers.set_replicas``
with ``parallel/mesh.py:use_mesh``'s ``spatial`` > 1) the forward takes the
rank's band of the image rows (``parallel/mesh.py:take_band``), records the
band plan of every plane it meets (:meth:`MNASNet.planes`,
``parallel/mesh.py:register_planes``), runs every k > 1 conv on its band's
window with the other ranks' halo rows, the fused MBConv and dw kernels in
eval mode too, and pools the bands' sums over the spatial group
(``parallel/spatial.py``). The logits are then the whole images' on every
rank of the group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    rows,
)
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fits_smem, mbconv_fused
from mnasnet_tpu_torch.ops.depthwise import (
    BN_BWD_IMPLS,
    IMPLS,
    depthwise_conv_bn_relu_fused,
    resolve_impl,
)
from mnasnet_tpu_torch.parallel.dist import SumTape, taped_sums
from mnasnet_tpu_torch.parallel.mesh import register_planes, spatial_of
from mnasnet_tpu_torch.parallel.spatial import exchanges, out_size, plane_rows, spatial_mean

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


def _bn_relu_train(bn: BatchNorm, x: torch.Tensor, region: bool):
    """Train-mode relu(bn(x)) without the running-stat update: (y, mean, var)."""
    if region:
        return bn.relu_train_forward(x)
    y, mean, var = bn.train_forward(x)
    return torch.relu(y), mean, var


def padded(width: int, pad: int) -> int:
    """``width`` rounded up to a multiple of ``pad`` (``mnasnet.py:109,255-257``)."""
    return -(-width // pad) * pad


class InvertedResidual(nn.Module):
    """MBConv block (torchvision's ``_InvertedResidual``).

    Input and output are NCHW tensors in channels_last memory. ``mid_pad``
    rounds the expanded width up to its multiple (``channel_pad``);
    ``pw_lowering`` is the expand and project convs' lowering; ``remat``
    recomputes the train-mode block in the backward (:meth:`_train`).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 expansion: int, dw_impl: str = "auto", bn_stats: str = "one_pass",
                 bn_ema: str = "module", bn_momentum: float = BN_MOMENTUM,
                 bn_bwd: str = "auto", pw_lowering: str = "dot", mid_pad: int = 1,
                 remat: bool = False):
        super().__init__()
        mid = padded(in_ch * expansion, mid_pad)
        self.in_ch, self.mid_ch, self.out_ch = in_ch, mid, out_ch
        self.kernel_size = kernel_size
        self.stride = stride
        self.dw_impl = dw_impl
        self.bn_bwd = bn_bwd
        self.remat = remat
        self.apply_residual = in_ch == out_ch and stride == 1
        kw = _bn_kw(bn_stats, bn_ema, bn_momentum)
        self.layers = nn.Sequential(
            PointwiseConv(in_ch, mid, pw_lowering),
            BatchNorm(mid, **kw),
            nn.ReLU(),
            DepthwiseConv(mid, kernel_size, stride, dw_impl),
            BatchNorm(mid, **kw),
            nn.ReLU(),
            PointwiseConv(mid, out_ch, pw_lowering),
            BatchNorm(out_ch, **kw),
        )

    def _use_fused_block(self, x: torch.Tensor, impl: str) -> bool:
        """The single-kernel fused block (ops/cuda/mbconv.py): eval mode only
        (``mnasnet.py:134``), on the kernel route, when the block has a
        shared-memory plan for its (padded) widths at the whole plane's
        height (on a band the kernel sees fewer rows)."""
        if self.training or impl != "kernel":
            return False
        rows = x.shape[2]
        if spatial_of(self.layers[3].replicas) is not None:
            rows = plane_rows(self.layers[3].replicas, nhwc(x))
        return mbconv_fits_smem(
            rows, x.shape[3], self.in_ch, self.mid_ch, self.out_ch,
            self.kernel_size, self.stride, x.element_size())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train(x)
        expand, expand_bn, _, dw, dw_bn, _, project, project_bn = self.layers
        impl = resolve_impl(self.dw_impl, x)
        if self._use_fused_block(x, impl):
            se, be = expand_bn.folded()
            sd, bd = dw_bn.folded()
            sp, bp = project_bn.folded()
            # On a band: the block's input window, whose 1x1 expand gives the
            # dw its halo rows; the residual is the window's own rows.
            return dw.on_band(x, lambda xw: mbconv_fused(
                xw, expand.matrix(), se, be, dw.kernel(), sd, bd,
                project.matrix(), sp, bp, kernel_size=self.kernel_size,
                stride=self.stride, residual=self.apply_residual), self.out_ch)
        y = torch.relu(expand_bn(expand(x)))
        if impl != "torch":
            s, b = dw_bn.folded()
            y = dw.on_band(y, lambda yw: depthwise_conv_bn_relu_fused(
                yw, dw.kernel(), s, b, stride=self.stride, impl=impl))
        else:
            y = torch.relu(dw_bn(dw(y)))
        y = project_bn(project(y))  # linear bottleneck
        if self.apply_residual:
            y = y + x
        return y

    def _train(self, x: torch.Tensor) -> torch.Tensor:
        """The train-mode block. Under ``remat`` (with grad enabled) its body
        runs under ``torch.utils.checkpoint`` (the reference's ``nn.remat``,
        ``mnasnet.py:275-277``): the backward recomputes it, on the kernels
        of its route. The body returns its BN moments and the running
        statistics update here, outside the checkpointed region, once per
        forward, as ``nn.remat`` returns the forward's ``batch_stats``. Under
        sync-BN the recompute replays the forward's global sums
        (``parallel/dist.py:taped_sums``): the same statistics, and no
        collective of its own. No random numbers are drawn in the block, so
        no RNG state is kept."""
        region = resolve_impl(self.bn_bwd, x) == "kernel"
        if self.remat and torch.is_grad_enabled():
            replicas = self.layers[1].replicas
            if replicas is None:
                out = checkpoint(self._train_body, x, region, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                tape = SumTape()

                def body(x):
                    with taped_sums(replicas, tape):
                        return self._train_body(x, region)

                out = checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)
        else:
            out = self._train_body(x, region)
        y, *moments = out
        for bn, r, (mean, var) in zip((self.layers[1], self.layers[4], self.layers[7]),
                                      (rows(x), rows(y), rows(y)),
                                      zip(moments[::2], moments[1::2])):
            bn.update_stats(r, mean, var)
        return y

    def _train_body(self, x: torch.Tensor, region: bool):
        """The train-mode block without the running-stat updates: the output
        and the three BNs' (mean, var)."""
        expand, expand_bn, _, dw, dw_bn, _, project, project_bn = self.layers
        y, m1, v1 = _bn_relu_train(expand_bn, expand(x), region)
        y, m2, v2 = _bn_relu_train(dw_bn, dw(y), region)
        y, m3, v3 = project_bn.train_forward(project(y))  # linear bottleneck
        if self.apply_residual:
            y = y + x
        return y, m1, v1, m2, v2, m3, v3


def _stack(in_ch, out_ch, kernel_size, stride, expansion, repeats, **kw):
    blocks = [InvertedResidual(in_ch if j == 0 else out_ch, out_ch, kernel_size,
                               stride if j == 0 else 1, expansion, **kw)
              for j in range(repeats)]
    return nn.Sequential(*blocks)


def kernel_width_problem(depths: list[int], channel_pad: int) -> str | None:
    """Why the kernel route cannot take these widths, or None: the dw kernel
    needs every depthwise width a multiple of 8 (which also gives the BN
    backward kernels their even widths). Only a ``channel_pad`` that is not
    a multiple of 8 makes such a width."""
    dw_widths = [depths[0]]
    in_ch = depths[1]
    for s, (_k, _stride, exp, repeats) in enumerate(STACKS):
        for _ in range(repeats):
            dw_widths.append(padded(in_ch * exp, channel_pad))
            in_ch = depths[2 + s]
    bad = sorted({c for c in dw_widths if c % 8})
    if not bad:
        return None
    return (f"channel_pad={channel_pad} gives depthwise widths {bad}, which the dw kernel "
            "cannot take (it needs multiples of 8): use a channel_pad that is a multiple "
            "of 8, or dw_impl and bn_bwd 'torch'")


class MNASNet(nn.Module):
    """MNASNet with depth multiplier ``alpha``.

    ``forward`` takes NCHW images (any memory format) and returns fp32 logits.
    ``seed`` seeds the ``torch.Generator`` of the weight init, which is the
    reference's (Kaiming-normal fan_out convs, Kaiming-uniform fan_out
    classifier, zero bias, unit BN). The module is built in eval mode.

    The reference's model knobs (``mnasnet.py:216-257``):

      * ``remat``: each MBConv block's train-mode forward is recomputed in
        the backward (:meth:`InvertedResidual._train`); the same step, less
        activation memory;
      * ``pw_lowering``: ``"dot"``, ``"conv"`` or ``"auto"`` for the blocks'
        expand and project convs (``layers.py:PointwiseConv``); the
        separable and head 1x1 convs stay matmuls, as the reference builds
        them as ``nn.Conv``;
      * ``channel_pad``: every width of :func:`get_depths` and every
        expanded width rounded up to a multiple of it. A padded model loads
        only a padded model's checkpoint (``convert/torch_converter.py:
        check_state_dict``). Widths the kernel route cannot take raise at
        construction on ``dw_impl``/``bn_bwd="kernel"`` and at the first
        forward of a CUDA tensor on ``"auto"``: the route is never swapped.
    """

    def __init__(self, alpha: float, num_classes: int = 1000, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32, dw_impl: str = "auto", seed: int = 0,
                 bn_stats: str = "one_pass", bn_ema: str = "module",
                 bn_momentum: float = BN_MOMENTUM, stem_s2d: bool = False,
                 bn_bwd: str = "auto", remat: bool = False, pw_lowering: str = "auto",
                 channel_pad: int = 1):
        super().__init__()
        for knob, value, choices in (("dw_impl", dw_impl, IMPLS),
                                     ("bn_bwd", bn_bwd, BN_BWD_IMPLS)):
            if value not in choices:
                raise ValueError(f"unknown {knob} {value!r}; choices: {choices}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, not {dtype}")
        if channel_pad < 1:
            raise ValueError(f"channel_pad must be >= 1, got {channel_pad}")
        self.alpha = alpha
        self.num_classes = num_classes
        self.dtype = dtype
        self.dw_impl = dw_impl
        self.bn_bwd = bn_bwd
        self.bn_ema = bn_ema
        self.bn_momentum = bn_momentum
        self.channel_pad = channel_pad
        kw = _bn_kw(bn_stats, bn_ema, bn_momentum)
        d = [padded(w, channel_pad) for w in get_depths(alpha)]
        self.width_problem = kernel_width_problem(d, channel_pad)
        if self.width_problem and "kernel" in (dw_impl, bn_bwd):
            raise ValueError(self.width_problem)
        stacks = []
        in_ch = d[1]
        for s, (k, stride, exp, repeats) in enumerate(STACKS):
            stacks.append(_stack(in_ch, d[2 + s], k, stride, exp, repeats, dw_impl=dw_impl,
                                 bn_stats=bn_stats, bn_ema=bn_ema, bn_momentum=bn_momentum,
                                 bn_bwd=bn_bwd, pw_lowering=pw_lowering,
                                 mid_pad=channel_pad, remat=remat))
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
        mesh = spatial_of(L[1].replicas)
        if mesh is not None:
            n, _, h, w = x.shape
            register_planes(L[1].replicas, n, self.planes(h * mesh.spatial, w),
                            counts=self.training)
        impl = resolve_impl(self.dw_impl, x)
        region = self.training and resolve_impl(self.bn_bwd, x) == "kernel"
        if self.width_problem and (impl == "kernel" or region):
            raise ValueError(self.width_problem)
        y = _bn_relu(L[1], L[0](x), region)
        if not self.training and impl != "torch":
            s, b = L[4].folded()
            y = L[3].on_band(y, lambda yw: depthwise_conv_bn_relu_fused(
                yw, L[3].kernel(), s, b, stride=1, impl=impl))
        else:
            y = _bn_relu(L[4], L[3](y), region)
        y = L[7](L[6](y))
        for stack in L[8:14]:
            y = stack(y)
        return _bn_relu(L[15], L[14](y), region)

    def planes(self, rows: int, cols: int) -> list[tuple[int, int]]:
        """(H, W) of every plane a forward on ``rows`` x ``cols`` images meets:
        the images, the stem's output and each strided stage's."""
        out = [(rows, cols)]
        strided = [(3, 2)] + [(b.kernel_size, b.stride) for stack in self.layers[8:14]
                              for b in stack if b.stride > 1]
        for k, stride in strided:
            rows, cols = out_size(rows, k, stride), out_size(cols, k, stride)
            out.append((rows, cols))
        return out

    def spatial_convs(self, rows: int) -> list[tuple[int, int, int]]:
        """(plane rows, k, stride) of every k > 1 conv of a forward on images
        of ``rows`` rows, in order: the stem, the separable dw, each block's
        dw."""
        convs = [(rows, 3, 2)]
        rows = out_size(rows, 3, 2)
        convs.append((rows, 3, 1))
        for stack in self.layers[8:14]:
            for b in stack:
                convs.append((rows, b.kernel_size, b.stride))
                rows = out_size(rows, b.kernel_size, b.stride)
        return convs

    def spatial_collectives(self, rows: int, parts: int, train: bool = True) -> int:
        """The collectives a forward (and with ``train`` its backward) on
        images of ``rows`` rows adds under a spatial mesh of ``parts`` ranks a
        group: a halo exchange each way for each k > 1 conv whose windows
        reach past a band (the stem's has no backward: the images need no
        gradient), and the pooled sums each way."""
        n = 0
        for i, (h, k, stride) in enumerate(self.spatial_convs(rows)):
            n += exchanges(h, parts, k, stride) * (1 + int(train and i > 0))
        return n + 1 + int(train)

    def dropout_keep(self, rows: int, generator: torch.Generator | None,
                     device) -> torch.Tensor | None:
        """The train-mode dropout mask of ``rows`` pooled feature rows (bool,
        true where a feature is kept), drawn from ``generator``; None when
        the model has no dropout."""
        p = self.classifier[0].p
        if p <= 0.0:
            return None
        width = self.classifier[1].in_features
        return torch.rand((rows, width), device=device, generator=generator) < 1.0 - p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """fp32 logits. In train mode dropout keeps the features where
        ``keep`` is true, or draws that mask from ``generator`` (the default
        generator of the device when None) when ``keep`` is None."""
        f = self.features(x)
        replicas = self.layers[1].replicas
        if spatial_of(replicas) is not None:  # global average pool, compute dtype
            y = spatial_mean(f, replicas, plane_rows(replicas, nhwc(f)))
        else:
            y = f.mean(dim=(2, 3))
        p = self.classifier[0].p
        if self.training and p > 0.0:
            if keep is None:
                keep = self.dropout_keep(y.shape[0], generator, y.device)
            y = torch.where(keep, y / (1.0 - p), torch.zeros_like(y))
        return self.classify(y)

    def classify(self, pooled: torch.Tensor) -> torch.Tensor:
        """fp32 logits of pooled features, computed as the reference's
        ``nn.Dense(dtype=self.dtype)``: the features, weight and bias cast to
        the compute dtype, the product rounded to it, the bias added in it,
        then one cast to fp32. Gradients flow through the casts."""
        fc = self.classifier[1]
        y = F.linear(pooled.to(self.dtype), fc.weight.to(self.dtype))
        return (y + fc.bias.to(self.dtype)).float()


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
    multiplier; ``efficientnet_b0`` and ``efficientnet_b4`` build those
    (``models/efficientnet.py``, which takes the same knobs but ``remat``
    and ``channel_pad``). ``kwargs`` go to :class:`MNASNet` (``num_classes``,
    ``dropout``, ``dtype``, ``dw_impl``, ``seed``, the training knobs
    ``bn_stats``, ``bn_ema``, ``bn_momentum``, ``stem_s2d``, ``bn_bwd``, and
    the model knobs ``remat``, ``pw_lowering``, ``channel_pad``). The
    weights are made on the CPU from ``seed`` and moved, so a seed gives the
    same weights on every device. ``device="cuda"`` without a card raises.
    """
    if name.startswith("efficientnet"):
        from mnasnet_tpu_torch.models.efficientnet import (
            EFFICIENTNET_REGISTRY,
            create_efficientnet,
        )

        if name not in EFFICIENTNET_REGISTRY:
            raise ValueError(f"unknown arch {name!r}; EfficientNet choices: "
                             f"{sorted(EFFICIENTNET_REGISTRY)}")
        return create_efficientnet(name, device=device, **kwargs)
    dev = resolve_device(device)
    if name in MODEL_REGISTRY:
        model = MODEL_REGISTRY[name](**kwargs)
    else:
        model = MNASNet(alpha=arch_alpha(name), **kwargs)
    return model.to(dev)
