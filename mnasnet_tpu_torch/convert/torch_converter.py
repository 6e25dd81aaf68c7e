"""torchvision-layout state_dict <-> JAX-package variables, numpy only.

Counterpart of ``mnasnet_tpu/convert/torch_converter.py``, with its own copy
of the layer map, so that the port never imports the JAX package. The port's
``MNASNet`` uses the torchvision names itself, so a torchvision ``.pth``
needs no conversion; these functions carry weights between the two packages:

  * :func:`torch_to_flax` and :func:`flax_to_torch` — the reference's two
    conversions, returning numpy arrays;
  * :func:`state_dict_from_jax` — ``{"params", "batch_stats"}`` of the JAX
    package (numpy arrays) to a state_dict that
    ``MNASNet.load_state_dict(strict=True)`` takes (a padded JAX model's
    widths to the port's model of the same ``channel_pad``);
  * :func:`params_from_jax` and :func:`params_to_jax` — any tree shaped like
    the parameters (gradients, the optimizer's ``ms``/``mom``/``trace``, the
    model-EMA shadow) between the JAX paths and the port's parameter names.

Layout transforms:
  * dense conv weight  OIHW (O,I,k,k)  -> HWIO (k,k,I,O)      transpose(2,3,1,0)
  * depthwise weight   (C,1,k,k)       -> HWIO (k,k,1,C)      transpose(2,3,1,0)
  * linear weight      (out,in)        -> (in,out)            transpose(1,0)
  * BN weight/bias/running_mean/running_var -> scale/bias + batch_stats

Only the v2 torchvision layout is accepted; v1 checkpoints (``_version < 2``)
are rejected instead of silently mis-loaded.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mnasnet_tpu_torch.models.mnasnet import STACKS, get_depths, padded


def _np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> np.ndarray."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _layer_map(alpha: float) -> list[tuple[str, tuple[str, ...], str]]:
    """Ordered (torch_prefix, flax_path, kind) triples, kind in
    {conv, dwconv, bn, linear}. Conv kernels live at flax_path + ('kernel',),
    the raw depthwise params at flax_path itself."""
    entries: list[tuple[str, tuple[str, ...], str]] = [
        ("layers.0", ("stem_conv",), "conv"),
        ("layers.1", ("stem_bn",), "bn"),
        ("layers.3", ("sep_dw_kernel",), "dwconv"),
        ("layers.4", ("sep_dw_bn",), "bn"),
        ("layers.6", ("sep_pw_conv",), "conv"),
        ("layers.7", ("sep_pw_bn",), "bn"),
    ]
    for s, (_k, _stride, _exp, repeats) in enumerate(STACKS):
        for j in range(repeats):
            t = f"layers.{8 + s}.{j}.layers"
            f = f"stage{s}_block{j}"
            entries += [
                (f"{t}.0", (f, "expand_conv"), "conv"),
                (f"{t}.1", (f, "expand_bn"), "bn"),
                (f"{t}.3", (f, "dw_kernel"), "dwconv"),
                (f"{t}.4", (f, "dw_bn"), "bn"),
                (f"{t}.6", (f, "project_conv"), "conv"),
                (f"{t}.7", (f, "project_bn"), "bn"),
            ]
    entries += [
        ("layers.14", ("head_conv",), "conv"),
        ("layers.15", ("head_bn",), "bn"),
        ("classifier.1", ("classifier",), "linear"),
    ]
    return entries


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _get(tree: Mapping, path: tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def strip_module_prefix(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Drop the leading ``module.`` that DataParallel checkpoints carry."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def _widths(alpha: float, channel_pad: int) -> dict[str, int]:
    """The output width of every 1x1 and stem conv weight by torchvision name."""
    d = [padded(w, channel_pad) for w in get_depths(alpha)]
    out = {"layers.0.weight": d[0], "layers.6.weight": d[1]}
    in_ch = d[1]
    for s, (_k, _stride, exp, repeats) in enumerate(STACKS):
        for j in range(repeats):
            t = f"layers.{8 + s}.{j}.layers"
            out[f"{t}.0.weight"] = padded(in_ch * exp, channel_pad)
            out[f"{t}.6.weight"] = d[2 + s]
            in_ch = d[2 + s]
    return out


def _width_mismatch(sd: Mapping[str, Any], widths: dict[str, int]):
    """The first (name, width in sd, width expected) that differ, or None."""
    for name, want in widths.items():
        w = sd.get(name)
        if w is not None and _np(w).shape[0] != want:
            return name, _np(w).shape[0], want
    return None


def check_state_dict(sd: Mapping[str, Any], alpha: float, channel_pad: int = 1) -> None:
    """Reject v1 checkpoints and widths that ``alpha`` and ``channel_pad``
    do not imply. A model with ``channel_pad`` > 1 is not
    checkpoint-compatible with the reference widths (``mnasnet.py:247-250``):
    where its widths differ from the unpadded ones, it loads only a padded
    model's own state_dict."""
    version = sd.get("_version", 2)
    if version is not None and not hasattr(version, "detach") and version < 2:
        raise ValueError(
            "v1 MNASNet checkpoints (alpha-scaled stem) are not supported; "
            "migrate with torchvision first"
        )
    bad = _width_mismatch(sd, _widths(alpha, channel_pad))
    if bad is None:
        return
    name, have, want = bad
    if channel_pad > 1 and _width_mismatch(sd, _widths(alpha, 1)) is None:
        raise ValueError(
            f"state_dict has the unpadded widths of alpha={alpha} ({name}: {have}), and "
            f"this model pads them with channel_pad={channel_pad} ({want}): a padded model "
            "is not checkpoint-compatible with the reference widths and loads only a "
            "padded model's own checkpoint"
        )
    if name == "layers.0.weight" and channel_pad == 1:
        raise ValueError(
            f"state_dict stem has {have} channels but alpha={alpha} implies {want}; "
            "wrong depth multiplier?"
        )
    raise ValueError(
        f"state_dict {name} has {have} channels but alpha={alpha} with "
        f"channel_pad={channel_pad} implies {want}; wrong depth multiplier or channel_pad?"
    )


def params_to_jax(named: Mapping[str, Any], alpha: float) -> dict:
    """A per-parameter tree by torchvision name (numpy arrays or tensors) as
    the JAX package's ``params`` tree, each leaf in the JAX layout."""
    named = strip_module_prefix(named)
    out: dict = {}
    for torch_prefix, flax_path, kind in _layer_map(alpha):
        w = _np(named[f"{torch_prefix}.weight"])
        if kind == "conv":
            _set(out, flax_path + ("kernel",), w.transpose(2, 3, 1, 0))
        elif kind == "dwconv":
            _set(out, flax_path, w.transpose(2, 3, 1, 0))
        elif kind == "bn":
            _set(out, flax_path + ("scale",), w)
            _set(out, flax_path + ("bias",), _np(named[f"{torch_prefix}.bias"]))
        elif kind == "linear":
            _set(out, flax_path + ("kernel",), w.T)
            _set(out, flax_path + ("bias",), _np(named[f"{torch_prefix}.bias"]))
    return out


def params_from_jax(tree: Mapping[str, Any], alpha: float) -> dict[str, np.ndarray]:
    """A tree shaped like the JAX package's ``params`` (numpy leaves) by the
    port's parameter names, each leaf in the torch layout."""
    out: dict[str, np.ndarray] = {}
    for torch_prefix, flax_path, kind in _layer_map(alpha):
        if kind == "conv":
            out[f"{torch_prefix}.weight"] = np.asarray(
                _get(tree, flax_path + ("kernel",))).transpose(3, 2, 0, 1)
        elif kind == "dwconv":
            out[f"{torch_prefix}.weight"] = np.asarray(_get(tree, flax_path)).transpose(3, 2, 0, 1)
        elif kind == "bn":
            out[f"{torch_prefix}.weight"] = np.asarray(_get(tree, flax_path + ("scale",)))
            out[f"{torch_prefix}.bias"] = np.asarray(_get(tree, flax_path + ("bias",)))
        elif kind == "linear":
            out[f"{torch_prefix}.weight"] = np.asarray(_get(tree, flax_path + ("kernel",))).T
            out[f"{torch_prefix}.bias"] = np.asarray(_get(tree, flax_path + ("bias",)))
    return out


def torch_to_flax(state_dict: Mapping[str, Any], alpha: float) -> dict:
    """A torchvision-layout state_dict to ``{"params", "batch_stats"}`` of the
    JAX package, as numpy arrays. Strips a leading ``module.``."""
    sd = strip_module_prefix(state_dict)
    check_state_dict(sd, alpha)
    batch_stats: dict = {}
    for torch_prefix, flax_path, kind in _layer_map(alpha):
        if kind == "bn":
            _set(batch_stats, flax_path + ("mean",), _np(sd[f"{torch_prefix}.running_mean"]))
            _set(batch_stats, flax_path + ("var",), _np(sd[f"{torch_prefix}.running_var"]))
    return {"params": params_to_jax(sd, alpha), "batch_stats": batch_stats}


def flax_to_torch(variables: Mapping[str, Any], alpha: float) -> dict[str, np.ndarray]:
    """``{"params", "batch_stats"}`` of the JAX package to a torchvision-layout
    state_dict of numpy arrays."""
    named = {**params_from_jax(variables["params"], alpha),
             **stats_from_jax(variables["batch_stats"], alpha)}
    out: dict[str, np.ndarray] = {}
    for torch_prefix, _, kind in _layer_map(alpha):
        names = {"bn": ("weight", "bias", "running_mean", "running_var"),
                 "linear": ("weight", "bias")}.get(kind, ("weight",))
        for name in names:
            out[f"{torch_prefix}.{name}"] = named[f"{torch_prefix}.{name}"]
        if kind == "bn":
            out[f"{torch_prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return out


def stats_from_jax(batch_stats: Mapping[str, Any], alpha: float) -> dict[str, np.ndarray]:
    """The JAX package's ``batch_stats`` tree by the port's buffer names
    (``running_mean``, ``running_var``)."""
    out: dict[str, np.ndarray] = {}
    for torch_prefix, flax_path, kind in _layer_map(alpha):
        if kind == "bn":
            out[f"{torch_prefix}.running_mean"] = np.asarray(_get(batch_stats, flax_path + ("mean",)))
            out[f"{torch_prefix}.running_var"] = np.asarray(_get(batch_stats, flax_path + ("var",)))
    return out


def state_dict_from_jax(variables_np: Mapping[str, Any], alpha: float) -> dict[str, torch.Tensor]:
    """The JAX package's ``{"params", "batch_stats"}`` (numpy arrays) as a
    state_dict that ``MNASNet(alpha).load_state_dict(strict=True)`` takes."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in flax_to_torch(variables_np, alpha).items()}
