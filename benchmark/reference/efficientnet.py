"""The plain reference: EfficientNet's forward, loss and training step in
float32 PyTorch, written out from the published architecture.

It imports nothing of the program under test, of the JAX package or of
JAX, and runs with TF32 off (``mnasnet_b1.fp32``, whose helpers it shares:
the input normalisation, the loss and the ``quant`` rounding). It takes the
benchmark's torchvision-layout state_dict and the configuration file's
object (``alpha``, ``base_depths``, ``first_stage_repeats``, ``stacks``,
``head_width``, ``se_ratio``, ``bn_eps``, ``bn_momentum``, ``dropout``,
``stochastic_depth``; widths and shapes from ``counting_efficientnet``)
and works out everything the program derives from them again.

EfficientNet (Tan & Le, arXiv:1905.11946; torchvision ``efficientnet_b*``):
  stem   conv3x3 s2 -> d0, BN, SiLU
  blocks each stage's MBConv blocks: [conv1x1 -> e*Cin, BN, SiLU], dw kxk
         (stride on the first), BN, SiLU; squeeze-and-excitation: the mean
         over H, W, conv1x1 with bias -> max(1, Cin/4), SiLU, conv1x1 with
         bias -> e*Cin, sigmoid, times the plane; conv1x1 -> Cout, BN; where
         Cin == Cout and the stride is 1, stochastic depth (block i of n
         kept with probability 1 - sd * i / n, per image, scaled by its
         inverse) plus the input
  head   conv1x1 -> head_width, BN, SiLU; mean over H, W; dropout; linear

Departures from the published description, each also the program's: the
BN epsilon and EMA decay are the configuration's (the paper's TF recipe,
1e-3 and 0.99; torchvision's modules default to 1e-5 and 0.1); the
dropout and stochastic-depth draws of a step are one uniform draw of
``rows x (head_width + residual blocks)`` against each column's keep
probability (:func:`dropout_keep`), where torchvision draws each module's
mask apart; the stem is the plain 3x3 stride-2 conv (the program's
space-to-depth stem is a re-layout of it). A train forward recomputes each
block in the backward (``torch.utils.checkpoint``), so that the float32
steps fit one card at the cell's batch; the batch statistics still span the
whole batch, and a block's recompute is its forward again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import counting_efficientnet as counting
from benchmark.reference.mnasnet_b1 import _q, cross_entropy, fp32, normalize_uint8


def keep_probability(cfg: dict) -> torch.Tensor:
    """Each column's keep probability, float32: ``head_width`` columns of
    the classifier dropout's ``1 - p``, then one of ``1 - sd * i / n`` for
    each residual block i (of n blocks), in order."""
    blocks = counting.block_shapes(cfg)
    n, sd = len(blocks), cfg["stochastic_depth"]
    probs = [1.0 - cfg["dropout"]] * cfg["head_width"]
    probs += [1.0 - sd * i / n for i, (_, _, cin, _, cout, _, s, _) in enumerate(blocks)
              if s == 1 and cin == cout]
    return torch.tensor(probs, dtype=torch.float32)


def dropout_keep(seed: int, steps: int, rows: int, cfg: dict, device) -> list[torch.Tensor]:
    """The masks of ``steps`` train steps: each step's ``rows`` x columns
    uniform draws below each column's keep probability, drawn in turn from
    one generator seeded with ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    prob = keep_probability(cfg).to(device)
    return [torch.rand((rows, prob.numel()), device=device, generator=g) < prob
            for _ in range(steps)]


class Net:
    """The forward of one state_dict of the configuration ``cfg``: ``sd``
    maps torchvision names to float32 tensors. A train forward keeps each
    BN's batch mean, biased variance and count of rows in ``batch_stats``,
    and every forward each BN's plane (rows of its input) in ``planes``."""

    def __init__(self, sd: dict, cfg: dict, *, quant: str | None = None):
        self.sd, self.cfg, self.quant = sd, cfg, quant
        self.eps, self.p = cfg["bn_eps"], cfg["dropout"]
        self.batch_stats: dict = {}
        self.planes: dict = {}

    def _conv(self, x, name, stride=1, groups=1, bias=False):
        w = self.sd[f"{name}.weight"]
        b = self.sd[f"{name}.bias"] if bias else None
        k = w.shape[-1]
        y = F.conv2d(_q(x, self.quant), _q(w, self.quant), b, stride=stride, padding=k // 2,
                     groups=groups)
        return _q(y, self.quant)

    def _bn(self, x, name, train: bool, silu: bool):
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
        return F.silu(y) if silu else y

    def _block(self, y, p: str, cin: int, cmid: int, stride: int, train: bool):
        i = 0
        z = y
        if cmid != cin:
            z = self._bn(self._conv(z, f"{p}.0.0"), f"{p}.0.1", train, True)
            i = 1
        z = self._bn(self._conv(z, f"{p}.{i}.0", stride=stride, groups=cmid), f"{p}.{i}.1",
                     train, True)
        s = z.mean(dim=(2, 3), keepdim=True)
        s = F.silu(self._conv(s, f"{p}.{i + 1}.fc1", bias=True))
        z = z * torch.sigmoid(self._conv(s, f"{p}.{i + 1}.fc2", bias=True))
        return self._bn(self._conv(z, f"{p}.{i + 2}.0"), f"{p}.{i + 2}.1", train, False)

    def features(self, x: torch.Tensor, train: bool, keep: torch.Tensor | None = None
                 ) -> torch.Tensor:
        cfg = self.cfg
        y = self._bn(self._conv(x, "features.0.0", stride=2), "features.0.1", train, True)
        blocks = counting.block_shapes(cfg)
        n, sd, head, column = len(blocks), cfg["stochastic_depth"], cfg["head_width"], 0
        stage_of = [s for s, (*_, r) in enumerate(counting.stages(cfg)) for _ in range(r)]
        first = 0
        for i, (_, _, cin, cmid, cout, _, stride, _) in enumerate(blocks):
            if i and stage_of[i] != stage_of[i - 1]:
                first = i
            p = f"features.{1 + stage_of[i]}.{i - first}.block"

            def body(t, p=p, cin=cin, cmid=cmid, stride=stride):
                return self._block(t, p, cin, cmid, stride, train)

            z = checkpoint(body, y, use_reentrant=False) if train and torch.is_grad_enabled() \
                else body(y)
            if stride == 1 and cin == cout:
                drop = sd * i / n
                if train and keep is not None:
                    z = z * (keep[:, head + column].float() / (1.0 - drop))[:, None, None, None]
                column += 1
                z = z + y
            y = z
        last = f"features.{1 + len(counting.stages(cfg))}"
        return self._bn(self._conv(y, f"{last}.0"), f"{last}.1", train, True)

    def logits(self, x: torch.Tensor, train: bool = False,
               keep: torch.Tensor | None = None) -> torch.Tensor:
        """Float32 logits of NCHW float32 images; in train mode batch
        statistics, stochastic depth and dropout by ``keep``."""
        y = self.features(x, train, keep).mean(dim=(2, 3))
        if train and keep is not None and self.p > 0.0:
            head = self.cfg["head_width"]
            y = torch.where(keep[:, :head], y / (1.0 - self.p), torch.zeros_like(y))
        w, b = self.sd["classifier.1.weight"], self.sd["classifier.1.bias"]
        return _q(_q(y, self.quant) @ _q(w, self.quant).t(), self.quant) + b


@torch.no_grad()
def serve_logits(sd: dict, cfg: dict, images: torch.Tensor, *, quant: str | None = None
                 ) -> torch.Tensor:
    """Eval-mode float32 logits of uint8 NHWC images."""
    with fp32():
        return Net(sd, cfg, quant=quant).logits(normalize_uint8(images))


def train_steps(sd: dict, cfg: dict, batches: list, keeps: list, decayed: dict, *,
                quant: str | None = None) -> dict:
    """``len(batches)`` training steps of the recipe ``cfg["train"]`` from
    the parameters of ``sd``, as ``mnasnet_b1.train_steps`` makes them: the
    train-mode forward (batch statistics, stochastic depth and dropout by
    ``keeps``), the label-smoothed loss, its gradients, TF-semantics
    RMSProp with coupled weight decay on the ``decayed`` parameters, and
    each BN's running statistics, an EMA of the step's batch moments at
    ``cfg["bn_momentum"]`` (the variance with Bessel's correction). Returns
    each step's loss, the first step's gradient (with its decay) by name,
    the parameters and running statistics after the last step, and each
    BN's plane."""
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
            del logits, loss
            with torch.no_grad():
                gd = {n: g + wd * params[n] if decayed[n] else g
                      for n, g in zip(params, grads)}
                del grads
                if first is None:
                    first = {n: g.clone() for n, g in gd.items()}
                for n, p in params.items():
                    ms[n].mul_(rho).add_((1.0 - rho) * gd[n] * gd[n])
                    mom[n].mul_(mu).add_(lr * gd[n] * torch.rsqrt(ms[n] + eps_r))
                    p.sub_(mom[n])
        return {"losses": losses, "first_grad": first,
                "params": {n: p.detach() for n, p in params.items()}, "stats": stats,
                "planes": net.planes}
