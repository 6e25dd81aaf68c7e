"""Seeded EfficientNet weights in torchvision's layout, made on the device.

As ``weights.py`` makes MNASNet's: the same state_dict for the program and
the plain reference, random from the run's seed in two large draws on the
device (one normal, one uniform) in the parameters' float32, each leaf a
view of those draws scaled per leaf, at ``weights.py``'s scales (He's
fan-in scale for the convs and the classifier, half that variance for a
linear projection, BN scales near one and the projections' near one half,
small shifts and means, running variances in [0.5, 1.5)). The
squeeze-and-excitation's 1x1 convs take He's scale too and small biases.
"""

from __future__ import annotations

import math

import torch

from benchmark import counting_efficientnet as counting
from benchmark.weights import _loc_scale as _mnasnet_loc_scale


def leaves(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the torchvision state_dict of
    the configuration ``cfg``, in its order. Kinds: ``weights.py``'s
    (``conv``, ``proj``, ``bn``, ``bn_proj``, ``mean``, ``var``, ``count``,
    ``fc``, ``fc_bias``) and ``se_bias``."""
    d, head = counting.depths(cfg), cfg["head_width"]
    out: list = []

    def conv(name, cout, cin, k, kind="conv"):
        out.append((f"{name}.weight", (cout, cin, k, k), kind))

    def bn(name, c, kind="bn"):
        out.extend([(f"{name}.weight", (c,), kind), (f"{name}.bias", (c,), kind),
                    (f"{name}.running_mean", (c,), "mean"), (f"{name}.running_var", (c,), "var"),
                    (f"{name}.num_batches_tracked", (), "count")])

    conv("features.0.0", d[0], 3, 3)
    bn("features.0.1", d[0])
    blocks = counting.block_shapes(cfg)
    per_stage = [r for *_, r in counting.stages(cfg)]
    at = 0
    for s, repeats in enumerate(per_stage):
        for j in range(repeats):
            _, _, cin, cmid, cout, k, _, sq = blocks[at]
            at += 1
            p, i = f"features.{1 + s}.{j}.block", 0
            if cmid != cin:
                conv(f"{p}.0.0", cmid, cin, 1)
                bn(f"{p}.0.1", cmid)
                i = 1
            conv(f"{p}.{i}.0", cmid, 1, k)
            bn(f"{p}.{i}.1", cmid)
            out.extend([(f"{p}.{i + 1}.fc1.weight", (sq, cmid, 1, 1), "conv"),
                        (f"{p}.{i + 1}.fc1.bias", (sq,), "se_bias"),
                        (f"{p}.{i + 1}.fc2.weight", (cmid, sq, 1, 1), "conv"),
                        (f"{p}.{i + 1}.fc2.bias", (cmid,), "se_bias")])
            conv(f"{p}.{i + 2}.0", cout, cmid, 1, "proj")
            bn(f"{p}.{i + 2}.1", cout, "bn_proj")
    last = f"features.{1 + len(per_stage)}"
    conv(f"{last}.0", head, d[-1], 1)
    bn(f"{last}.1", head)
    out.append(("classifier.1.weight", (cfg["num_classes"], head), "fc"))
    out.append(("classifier.1.bias", (cfg["num_classes"],), "fc_bias"))
    return out


def _loc_scale(name: str, shape: tuple, kind: str) -> tuple[float, float]:
    if kind == "se_bias":
        return 0.0, 0.05
    return _mnasnet_loc_scale(name, shape, kind)


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
    """Weight decay applies to every conv weight (the squeeze-and-excitation's
    too) and the classifier weight, never to a BN parameter or a bias."""
    return {n: k in ("conv", "proj", "fc") for n, _, k in leaves(cfg)
            if k not in ("mean", "var", "count")}
