"""The plain reference: MNASNet-B1's forward, loss and training step in
float32 PyTorch, written out from the published architecture.

It imports nothing of the program under test, of the JAX package or of
JAX, and runs with TF32 off (``fp32``). It takes the benchmark's
torchvision-layout state_dict and the configuration file's object (its
``alpha``, ``base_depths``, ``stacks``, ``bn_eps``, ``bn_momentum``,
``dropout``) and works out everything the program derives from them again:
the BN scales from the running statistics (eval) or the batch (train), the
running statistics' EMA, the plain 3x3 stride-2 stem (the program's
space-to-depth stem is a re-layout of the same conv), the input
normalisation of uint8 images.

MNASNet-B1 (torchvision ``mnasnet``; MnasNet, arXiv:1807.11626):
  stem   conv3x3 s2 -> d0, BN, ReLU
  sep    dw3x3 s1, BN, ReLU, conv1x1 -> d1, BN
  blocks for each stage (k, s, e, r): r blocks of conv1x1 -> e*Cin, BN, ReLU,
         dw kxk (stride s on the first), BN, ReLU, conv1x1 -> Cout, BN,
         plus the input where Cin == Cout and the stride is 1
  head   conv1x1 -> 1280, BN, ReLU; mean over H, W; dropout; linear

``quant="fp8"`` rounds every conv's and the classifier's operands and
output to FP8 (E4M3 with a per-tensor scale, as FP8 GEMMs take them), and
in the backward the gradients at the same points to E5M2: the precision
below bfloat16, the control that the comparison has to fail.
``quant="bf16"`` rounds at the same points to bfloat16: the program's
precision, computed the reference's way (a second witness of what bf16
alone does to a number).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def depths(cfg: dict) -> list[int]:
    """The configuration's widths at its alpha, rounded as torchvision
    rounds them."""
    def rnd(val):
        new = max(8, int(val + 4) // 8 * 8)
        return new if new >= 0.9 * val else new + 8

    return [rnd(d * cfg["alpha"]) for d in cfg["base_depths"]]


@contextlib.contextmanager
def fp32():
    """Float32 matmuls and convs without TF32 inside."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


_ROUNDING = {"fp8": _Fp8, "bf16": _Bf16}


def _q(t: torch.Tensor, quant: str | None) -> torch.Tensor:
    return t if quant is None else _ROUNDING[quant].apply(t)


class Net:
    """The forward of one state_dict of the configuration ``cfg``: ``sd``
    maps torchvision names to float32 tensors (parameters taken as they
    are, so that autograd reaches them when they require grad). A train
    forward keeps each BN's batch mean, biased variance and count of rows
    in ``batch_stats``, and every forward each BN's plane (rows of its
    input) in ``planes``."""

    def __init__(self, sd: dict, cfg: dict, *, quant: str | None = None):
        self.sd, self.cfg, self.quant = sd, cfg, quant
        self.eps, self.p = cfg["bn_eps"], cfg["dropout"]
        self.batch_stats: dict = {}
        self.planes: dict = {}

    def _conv(self, x, name, stride=1, groups=1):
        w = self.sd[f"{name}.weight"]
        k = w.shape[-1]
        y = F.conv2d(_q(x, self.quant), _q(w, self.quant), stride=stride, padding=k // 2,
                     groups=groups)
        return _q(y, self.quant)

    def _bn(self, x, name, train: bool, relu: bool):
        sd = self.sd
        self.planes[name] = x.shape[2]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            self.batch_stats[name] = (mean.detach(), var.detach(), x.numel() // x.shape[1])
        else:
            mean, var = sd[f"{name}.running_mean"], sd[f"{name}.running_var"]
        inv = sd[f"{name}.weight"] / torch.sqrt(var + self.eps)
        y = (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + sd[f"{name}.bias"][None, :, None, None]
        return torch.relu(y) if relu else y

    def features(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        d = depths(self.cfg)
        y = self._bn(self._conv(x, "layers.0", stride=2), "layers.1", train, True)
        y = self._bn(self._conv(y, "layers.3", groups=d[0]), "layers.4", train, True)
        y = self._bn(self._conv(y, "layers.6"), "layers.7", train, False)
        in_ch = d[1]
        for s, (k, stride, exp, repeats) in enumerate(self.cfg["stacks"]):
            for j in range(repeats):
                p = f"layers.{8 + s}.{j}.layers"
                st = stride if j == 0 else 1
                z = self._bn(self._conv(y, f"{p}.0"), f"{p}.1", train, True)
                z = self._bn(self._conv(z, f"{p}.3", stride=st, groups=in_ch * exp),
                             f"{p}.4", train, True)
                z = self._bn(self._conv(z, f"{p}.6"), f"{p}.7", train, False)
                y = z + y if (in_ch == d[2 + s] and st == 1) else z
                in_ch = d[2 + s]
        return self._bn(self._conv(y, "layers.14"), "layers.15", train, True)

    def logits(self, x: torch.Tensor, train: bool = False,
               keep: torch.Tensor | None = None) -> torch.Tensor:
        """Float32 logits of NCHW float32 images; in train mode batch
        statistics and dropout where ``keep`` is false."""
        y = self.features(x, train).mean(dim=(2, 3))
        if train and keep is not None and self.p > 0.0:
            y = torch.where(keep, y / (1.0 - self.p), torch.zeros_like(y))
        w, b = self.sd["classifier.1.weight"], self.sd["classifier.1.bias"]
        return _q(_q(y, self.quant) @ _q(w, self.quant).t(), self.quant) + b


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC RGB 0-255 -> normalised float32 NCHW (torchvision's
    ``ToTensor`` and ``Normalize``)."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return ((images.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


@torch.no_grad()
def serve_logits(sd: dict, cfg: dict, images: torch.Tensor, *, quant: str | None = None
                 ) -> torch.Tensor:
    """Eval-mode float32 logits of uint8 NHWC images."""
    with fp32():
        return Net(sd, cfg, quant=quant).logits(normalize_uint8(images))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, smoothing: float) -> torch.Tensor:
    """Mean over the batch of (1 - e) * NLL + e * mean(-log p)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    return ((1.0 - smoothing) * nll + smoothing * (-logp.mean(dim=-1))).mean()


def dropout_keep(seed: int, steps: int, rows: int, width: int, p: float, device
                 ) -> list[torch.Tensor]:
    """The keep masks of ``steps`` train steps: each step's ``rows`` x
    ``width`` uniform draws below 1 - p, drawn in turn from one generator
    seeded with ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    return [torch.rand((rows, width), device=device, generator=g) < 1.0 - p
            for _ in range(steps)]


def train_steps(sd: dict, cfg: dict, batches: list, keeps: list, decayed: dict, *,
                quant: str | None = None) -> dict:
    """``len(batches)`` training steps of the recipe ``cfg["train"]`` from
    the parameters of ``sd``: train-mode forward (batch statistics, dropout
    by ``keeps``), the label-smoothed loss, its gradients, TF-semantics
    RMSProp with coupled weight decay on the ``decayed`` parameters::

        g'  = g + wd * p            (decayed parameters)
        ms  = decay * ms + (1 - decay) * g'^2        (ms starts at 1)
        mom = momentum * mom + lr * g' / sqrt(ms + eps)
        p   = p - mom

    and each BN's running statistics, an EMA of the step's batch moments at
    ``m = cfg["bn_momentum"]`` (the variance with Bessel's correction over
    the batch's rows)::

        running_mean = m * running_mean + (1 - m) * mean
        running_var  = m * running_var  + (1 - m) * var * n / (n - 1)

    Batches are (NHWC float32 images, int labels). Returns each step's
    loss, the first step's g' by parameter name, the parameters and the
    running statistics after the last step, and each BN's plane."""
    recipe, m = cfg["train"], cfg["bn_momentum"]
    with fp32():
        params = {n: sd[n].detach().clone().requires_grad_(True) for n in decayed}
        stats = {n: t.detach().clone() for n, t in sd.items()
                 if n.endswith(("running_mean", "running_var"))}
        buffers = {n: t for n, t in sd.items() if n not in decayed}
        ms = {n: torch.ones_like(p) for n, p in params.items()}
        mom = {n: torch.zeros_like(p) for n, p in params.items()}
        lr, wd = recipe["learning_rate"], recipe["weight_decay"]
        rho, mu, eps_r = recipe["rmsprop_decay"], recipe["momentum"], recipe["rmsprop_eps"]
        losses, first = [], None
        for (images, labels), keep in zip(batches, keeps):
            net = Net({**buffers, **params}, cfg, quant=quant)
            logits = net.logits(images.permute(0, 3, 1, 2), train=True, keep=keep)
            for name, (mean, var, n) in net.batch_stats.items():
                rm, rv = stats[f"{name}.running_mean"], stats[f"{name}.running_var"]
                rm.copy_(m * rm + (1.0 - m) * mean)
                rv.copy_(m * rv + (1.0 - m) * var * (n / max(n - 1, 1)))
            loss = cross_entropy(logits, labels, recipe["label_smoothing"])
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                gd = {n: g + wd * params[n] if decayed[n] else g
                      for n, g in zip(params, grads)}
                if first is None:
                    first = {n: g.clone() for n, g in gd.items()}
                for n, p in params.items():
                    ms[n].mul_(rho).add_((1.0 - rho) * gd[n] * gd[n])
                    mom[n].mul_(mu).add_(lr * gd[n] * torch.rsqrt(ms[n] + eps_r))
                    p.sub_(mom[n])
        return {"losses": losses, "first_grad": first,
                "params": {n: p.detach() for n, p in params.items()}, "stats": stats,
                "planes": net.planes}
