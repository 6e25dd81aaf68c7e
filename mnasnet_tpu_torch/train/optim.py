"""Optimizers of the MNASNet recipe: SGD+momentum and TF-semantics RMSProp.

Counterpart of ``mnasnet_tpu/train/optim.py``. The JAX package composes optax
transformations; here each transformation is an object that owns its state,
is bound to a model with ``init(model)``, and turns a dict of gradients (by
parameter name) into a dict of updates with ``update(grads)``. The train step
adds the updates to the parameters (``p + u``, as ``optax.apply_updates``).
Every per-element formula is the reference's, in its order of operations:

  * :func:`rmsprop_tf` (``optim.py:331``): ``ms`` starts at ones, eps inside
    the rsqrt, lr inside the momentum, lr from the schedule at the update
    count *before* its increment::

        ms  = decay·ms + (1−decay)·g²
        mom = momentum·mom + lr·g·rsqrt(ms + eps)
        u   = −mom

    ``torch.optim.RMSprop`` differs on all three and is not used.
  * :func:`sgd` (``optim.py:312``): ``t = g + momentum·t``, ``u = −lr·t``.
  * Both add coupled weight decay first, ``g + wd·p``, on the parameters of
    :func:`wd_mask`: every conv weight (depthwise included) and the
    classifier weight; never a BN weight or bias, nor the classifier bias.
    The mask goes by module type, because torchvision's names call both a
    conv kernel and a BN scale ``weight``.
  * :func:`freeze` (``optim.py:207``) zeroes the *final* updates of the
    frozen parameters, after weight decay.
  * :func:`with_model_ema` (``optim.py:231``) keeps the TF moving average of
    the post-update parameters, ``e −= (1 − d)·(e − p)`` with
    ``d = min(decay, (1+n)/(10+n))``; :func:`get_ema_params` reads it.

Each transformation saves and restores its state by parameter name with
``state_dict()`` / ``load_state_dict()`` (CPU tensors and plain numbers, so
``torch.load(weights_only=True)`` reads them back): ``count``, ``ms``,
``mom``, ``trace``, the EMA shadow, and a wrapper's ``inner`` state.

``fused`` picks how the arithmetic is issued, not what it is: ``True`` runs
every formula as ``torch._foreach_*`` ops over all parameters at once,
``"small"`` over the 1-D (per-channel) parameters only, as the reference's
``fused_flat(small_only=True)`` packs them, and the rest one tensor at a
time; ``False`` one tensor at a time throughout.
"""

from __future__ import annotations

from typing import Callable, Mapping, Union

import numpy as np
import torch
from torch import nn

from mnasnet_tpu_torch.models.layers import DepthwiseConv, PointwiseConv, StemConv

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]
Mask = Union[Mapping[str, bool], Callable[[nn.Module], Mapping[str, bool]]]

_DECAYED = (StemConv, DepthwiseConv, PointwiseConv, nn.Linear)


def wd_mask(model: nn.Module) -> dict[str, bool]:
    """True where weight decay applies (``_wd_mask``, ``optim.py:73``): the
    weight of every conv and of the classifier; False for BN weights and
    biases and the classifier bias."""
    out = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            out[name] = isinstance(mod, _DECAYED) and p_name == "weight"
    return out


def backbone_frozen_mask(model: nn.Module) -> dict[str, bool]:
    """True (frozen) for every parameter except the classifier's
    (``optim.py:196``): the linear-probe recipe."""
    return {name: not name.startswith("classifier.") for name, _ in model.named_parameters()}


def _resolve_mask(mask: Mask, model: nn.Module) -> dict[str, bool]:
    return dict(mask(model) if callable(mask) else mask)


def _lr_at(learning_rate: ScalarOrSchedule, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


class _Transform:
    """Bound to a model's parameters by :meth:`init`; ``update`` maps grads to
    updates, both dicts keyed by parameter name."""

    names: list[str]
    params: dict[str, torch.Tensor]

    def init(self, model: nn.Module) -> None:
        self.params = dict(model.named_parameters())
        self.names = list(self.params)

    def update(self, grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    # The state saved by state_dict(): plain numbers, and dicts of tensors by
    # parameter name, by attribute; a wrapper's inner state goes under "inner".
    _SCALARS: tuple[str, ...] = ()
    _TENSORS: tuple[str, ...] = ()

    def _fields(self) -> set[str]:
        return {*self._SCALARS, *self._TENSORS, *(("inner",) if hasattr(self, "inner") else ())}

    def state_dict(self) -> dict:
        out: dict = {f: getattr(self, f) for f in self._SCALARS}
        for f in self._TENSORS:
            out[f] = {n: t.detach().cpu().clone() for n, t in getattr(self, f).items()}
        if hasattr(self, "inner"):
            out["inner"] = self.inner.state_dict()
        return out

    def load_state_dict(self, state: Mapping) -> None:
        """Copy a :meth:`state_dict` into the bound state, in place (the
        tensors stay on the parameters' device); raises if a field or a
        parameter name is missing or extra."""
        if set(state) != self._fields():
            raise ValueError(f"{type(self).__name__} state has fields {sorted(state)}, "
                             f"expected {sorted(self._fields())}")
        with torch.no_grad():
            for f in self._TENSORS:
                mine, saved = getattr(self, f), state[f]
                if set(saved) != set(mine):
                    raise ValueError(f"{type(self).__name__}.{f}: parameter names differ: "
                                     f"{sorted(set(saved) ^ set(mine))[:4]}")
                for n, t in mine.items():
                    t.copy_(saved[n])
        for f in self._SCALARS:
            setattr(self, f, int(state[f]))
        if hasattr(self, "inner"):
            self.inner.load_state_dict(state["inner"])


class _Core(_Transform):
    """Shared part of :class:`RmsPropTF` and :class:`SGD`: the masked coupled
    weight decay and the grouping of the per-element math by ``fused``."""

    _SCALARS = ("count",)

    def __init__(self, learning_rate: ScalarOrSchedule, weight_decay: float, mask: Mask,
                 fused: bool | str):
        if fused not in (False, True, "small"):
            raise ValueError(f"fused must be False, True or 'small', not {fused!r}")
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.mask = mask
        self.fused = fused
        self.count = 0

    def init(self, model: nn.Module) -> None:
        super().init(model)
        self.decayed = _resolve_mask(self.mask, model)
        self.count = 0
        if self.fused is True:
            self.groups = [self.names]
        elif self.fused == "small":
            small = [n for n in self.names if self.params[n].dim() == 1]
            self.groups = [small] + [[n] for n in self.names if self.params[n].dim() != 1]
        else:
            self.groups = [[n] for n in self.names]

    def _decayed_grads(self, grads, names) -> list[torch.Tensor]:
        """``g + wd·p`` on the masked parameters, ``g`` elsewhere."""
        g = [grads[n] for n in names]
        if not self.weight_decay:
            return g
        dec = [i for i, n in enumerate(names) if self.decayed[n]]
        if dec:
            wp = torch._foreach_mul([self.params[names[i]].detach() for i in dec],
                                    self.weight_decay)
            summed = torch._foreach_add([g[i] for i in dec], wp)
            for i, v in zip(dec, summed):
                g[i] = v
        return g

    def update(self, grads):
        lr = _lr_at(self.learning_rate, self.count)
        out = {}
        for names in self.groups:
            if names:
                out.update(zip(names, self._group_update(names, self._decayed_grads(grads, names),
                                                         lr)))
        self.count += 1
        return out


class RmsPropTF(_Core):
    """TF-semantics RMSProp with coupled masked weight decay; see the module
    docstring. State: ``count``, ``ms`` and ``mom`` by parameter name."""

    _TENSORS = ("ms", "mom")

    def __init__(self, learning_rate, decay=0.9, momentum=0.9, eps=1e-3, weight_decay=1e-5,
                 mask: Mask = wd_mask, fused: bool | str = False):
        super().__init__(learning_rate, weight_decay, mask, fused)
        self.decay, self.momentum, self.eps = decay, momentum, eps

    def init(self, model):
        super().init(model)
        self.ms = {n: torch.ones_like(p, memory_format=torch.contiguous_format)
                   for n, p in self.params.items()}
        self.mom = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                    for n, p in self.params.items()}

    def _group_update(self, names, g, lr):
        ms = [self.ms[n] for n in names]
        mom = [self.mom[n] for n in names]
        # ms = decay·ms + (1−decay)·g²
        torch._foreach_mul_(ms, self.decay)
        torch._foreach_add_(ms, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.decay))
        # mom = momentum·mom + (lr·g)·rsqrt(ms + eps)
        step = torch._foreach_mul(torch._foreach_mul(g, lr),
                                  torch._foreach_rsqrt(torch._foreach_add(ms, self.eps)))
        torch._foreach_mul_(mom, self.momentum)
        torch._foreach_add_(mom, step)
        return torch._foreach_neg(mom)


class SGD(_Core):
    """SGD with (optionally Nesterov) momentum and coupled masked weight
    decay (optax ``trace`` then ``scale_by_learning_rate``). State:
    ``count`` and ``trace`` by parameter name."""

    _TENSORS = ("trace",)

    def __init__(self, learning_rate, momentum=0.9, weight_decay=1e-5, nesterov=False,
                 mask: Mask = wd_mask, fused: bool | str = False):
        super().__init__(learning_rate, weight_decay, mask, fused)
        self.momentum, self.nesterov = momentum, nesterov

    def init(self, model):
        super().init(model)
        self.trace = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                      for n, p in self.params.items()}

    def _group_update(self, names, g, lr):
        tr = [self.trace[n] for n in names]
        new = torch._foreach_add(g, torch._foreach_mul(tr, self.momentum))  # g + momentum·t
        torch._foreach_copy_(tr, new)
        if self.nesterov:
            new = torch._foreach_add(g, torch._foreach_mul(new, self.momentum))
        return torch._foreach_mul(new, -lr)


def rmsprop_tf(learning_rate: ScalarOrSchedule, decay: float = 0.9, momentum: float = 0.9,
               eps: float = 1e-3, weight_decay: float = 1e-5, mask: Mask = wd_mask,
               fused: bool | str = False) -> RmsPropTF:
    """TF-semantics RMSProp of the MnasNet recipe (``optim.py:331``)."""
    return RmsPropTF(learning_rate, decay, momentum, eps, weight_decay, mask, fused)


def sgd(learning_rate: ScalarOrSchedule, momentum: float = 0.9, weight_decay: float = 1e-5,
        nesterov: bool = False, mask: Mask = wd_mask, fused: bool | str = False) -> SGD:
    """SGD+momentum with coupled masked weight decay (``optim.py:312``)."""
    return SGD(learning_rate, momentum, weight_decay, nesterov, mask, fused)


class Freeze(_Transform):
    """:func:`freeze`: the inner transformation, then zero updates for the
    frozen parameters (their optimizer state still advances)."""

    def __init__(self, inner: _Transform, frozen_mask: Mask):
        self.inner = inner
        self.frozen_mask = frozen_mask

    def init(self, model):
        super().init(model)
        self.inner.init(model)
        self.frozen = _resolve_mask(self.frozen_mask, model)

    def update(self, grads):
        out = self.inner.update(grads)
        return {n: torch.zeros_like(u) if self.frozen.get(n, False) else u
                for n, u in out.items()}


def freeze(tx: _Transform, frozen_mask: Mask) -> Freeze:
    """Zero the FINAL updates of frozen parameters (``optim.py:207``), after
    the coupled weight decay inside ``tx``, so frozen weights never decay.
    BN running statistics keep updating in train mode, as in torch."""
    return Freeze(tx, frozen_mask)


class ModelEma(_Transform):
    """:func:`with_model_ema`: the inner transformation, then the moving
    average of the post-update parameters. State: ``count`` and the shadow
    ``ema_params`` by parameter name."""

    _SCALARS = ("count",)
    _TENSORS = ("ema_params",)

    def __init__(self, inner: _Transform, decay: float, warmup: bool):
        self.inner = inner
        self.decay = decay
        self.warmup = warmup

    def init(self, model):
        super().init(model)
        self.inner.init(model)
        self.count = 0
        self.ema_params = {n: p.detach().clone(memory_format=torch.contiguous_format)
                           for n, p in self.params.items()}

    def update(self, grads):
        out = self.inner.update(grads)
        self.count += 1
        # d in fp32, as the reference computes it.
        d = np.float32(self.decay)
        if self.warmup:
            n = np.float32(self.count)
            d = min(d, (np.float32(1.0) + n) / (np.float32(10.0) + n))
        one_minus_d = float(np.float32(1.0) - d)
        names = self.names
        shadow = [self.ema_params[n] for n in names]
        new_params = torch._foreach_add([self.params[n].detach() for n in names],
                                        [out[n] for n in names])
        diff = torch._foreach_sub(shadow, new_params)
        torch._foreach_sub_(shadow, torch._foreach_mul(diff, one_minus_d))
        return out


def with_model_ema(tx: _Transform, decay: float = 0.9999, warmup: bool = True) -> ModelEma:
    """Keep the TF exponential moving average of the post-update parameters
    (``optim.py:231``): shadow initialised to the parameters, then
    ``shadow −= (1 − d)·(shadow − param)`` per update with
    ``d = min(decay, (1+n)/(10+n))`` when ``warmup``. BN statistics are not
    averaged again: they carry their own EMA."""
    return ModelEma(tx, decay, warmup)


def get_ema_params(tx: _Transform) -> dict[str, torch.Tensor] | None:
    """The EMA shadow parameters by name, or None when no model EMA is
    active; searches through wrapper transformations."""
    while tx is not None:
        if isinstance(tx, ModelEma):
            return tx.ema_params
        tx = getattr(tx, "inner", None)
    return None


def create_optimizer(name: str, learning_rate: ScalarOrSchedule, momentum: float = 0.9,
                     weight_decay: float = 1e-5, rmsprop_decay: float = 0.9,
                     rmsprop_eps: float = 1e-3, fused: bool | str = False,
                     model_ema: float | None = None, model_ema_warmup: bool = True,
                     frozen_mask: Mask | None = None) -> _Transform:
    """``create_optimizer`` of ``optim.py:383``: ``"sgd"`` or ``"rmsprop"``,
    then :func:`freeze` when ``frozen_mask`` is given (a dict by parameter
    name or a callable of the model, True = frozen), then
    :func:`with_model_ema` outermost when ``model_ema`` is a decay. Bind it
    to a model with ``init(model)`` (``TrainState.create`` does)."""
    if name == "sgd":
        tx = sgd(learning_rate, momentum=momentum, weight_decay=weight_decay, fused=fused)
    elif name == "rmsprop":
        tx = rmsprop_tf(learning_rate, decay=rmsprop_decay, momentum=momentum, eps=rmsprop_eps,
                        weight_decay=weight_decay, fused=fused)
    else:
        raise ValueError(f"unknown optimizer {name!r} (choices: sgd, rmsprop)")
    if frozen_mask is not None:
        tx = freeze(tx, frozen_mask)
    if model_ema:
        if not 0.0 < model_ema < 1.0:
            raise ValueError(f"model_ema decay must be in (0, 1), got {model_ema}")
        tx = with_model_ema(tx, model_ema, warmup=model_ema_warmup)
    return tx
