"""Seeded MNASNet-B1 weights in torchvision's layout, made on the device.

The benchmark makes the weights and hands the same state_dict to the
program and to the plain reference. They are random, from the run's seed,
in two large draws on the device (one normal, one uniform) in float32, the
parameters' type; each leaf is a view of those draws, scaled per leaf.

Scales keep the eval forward's activations of order one through the 17
blocks: convs and the classifier at He's fan-in scale (a linear projection
at half its variance), BN scales near one (the projections' near one
half, so that the residual sums grow slowly), small shifts and means, and
running variances in [0.5, 1.5).
"""

from __future__ import annotations

import math

import torch

from benchmark import counting


def leaves(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the torchvision state_dict of
    the configuration ``cfg`` (its widths and stages), in its order. Kinds:
    ``conv``, ``proj`` (a linear bottleneck's 1x1 conv), ``bn``, ``bn_proj``
    (a BN with no ReLU after it), ``fc``."""
    d, head, num_classes = counting.depths(cfg), cfg["head_width"], cfg["num_classes"]
    out: list = []

    def conv(name, cout, cin, k, kind="conv"):
        out.append((f"{name}.weight", (cout, cin, k, k), kind))

    def bn(name, c, kind="bn"):
        out.extend([(f"{name}.weight", (c,), kind), (f"{name}.bias", (c,), kind),
                    (f"{name}.running_mean", (c,), "mean"), (f"{name}.running_var", (c,), "var"),
                    (f"{name}.num_batches_tracked", (), "count")])

    conv("layers.0", d[0], 3, 3)
    bn("layers.1", d[0])
    conv("layers.3", d[0], 1, 3)
    bn("layers.4", d[0])
    conv("layers.6", d[1], d[0], 1, "proj")
    bn("layers.7", d[1], "bn_proj")
    in_ch = d[1]
    for s, (k, _stride, exp, repeats) in enumerate(cfg["stacks"]):
        for j in range(repeats):
            p = f"layers.{8 + s}.{j}.layers"
            mid = in_ch * exp
            conv(f"{p}.0", mid, in_ch, 1)
            bn(f"{p}.1", mid)
            conv(f"{p}.3", mid, 1, k)
            bn(f"{p}.4", mid)
            conv(f"{p}.6", d[2 + s], mid, 1, "proj")
            bn(f"{p}.7", d[2 + s], "bn_proj")
            in_ch = d[2 + s]
    conv("layers.14", head, in_ch, 1)
    bn("layers.15", head)
    out.append(("classifier.1.weight", (num_classes, head), "fc"))
    out.append(("classifier.1.bias", (num_classes,), "fc_bias"))
    return out


def _loc_scale(name: str, shape: tuple, kind: str) -> tuple[float, float]:
    """(mean, standard deviation) of a normally drawn leaf."""
    if kind in ("conv", "proj"):
        fan_in = shape[1] * shape[2] * shape[3]
        return 0.0, math.sqrt((2.0 if kind == "conv" else 1.0) / fan_in)
    if kind in ("bn", "bn_proj"):
        if name.endswith(".weight"):
            return (1.0 if kind == "bn" else 0.5), 0.1
        return 0.0, 0.05
    if kind == "mean":
        return 0.0, 0.05
    if kind == "fc":
        return 0.0, math.sqrt(1.0 / shape[1])
    if kind == "fc_bias":
        return 0.0, 0.01
    raise ValueError(f"no normal draw for {kind}")


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    """The seeded state_dict of ``cfg`` in its ``param_dtype``
    (``num_batches_tracked`` 0, int64) on ``device``: the same seed gives
    the same weights."""
    spec = leaves(cfg)
    dtype = getattr(torch, cfg["param_dtype"])
    normal = [(n, s, k) for n, s, k in spec if k not in ("var", "count")]
    uniform = [(n, s, k) for n, s, k in spec if k == "var"]
    sizes = [math.prod(s) for _, s, _ in normal]
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    z = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
    loc, scale = zip(*(_loc_scale(n, s, k) for n, s, k in normal))
    counts = torch.tensor(sizes, device=device)
    z = (z * torch.repeat_interleave(torch.tensor(scale, device=device, dtype=dtype), counts)
         + torch.repeat_interleave(torch.tensor(loc, device=device, dtype=dtype), counts))
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=g, device=device,
                   dtype=dtype) + 0.5
    out = {}
    for part, flat in ((normal, z), (uniform, u)):
        at = 0
        for name, shape, _ in part:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape)
            at += n
    for name, shape, kind in spec:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return {name: out[name] for name, _, _ in spec}


def decayed(cfg: dict) -> dict[str, bool]:
    """Weight decay applies to every conv weight and the classifier weight,
    never to a BN parameter or the classifier bias (the recipe's rule)."""
    return {n: k in ("conv", "proj", "fc") for n, _, k in leaves(cfg)
            if k not in ("mean", "var", "count")}
