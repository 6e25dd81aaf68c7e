"""Serving-side loader for the port's ``torch.export`` artifacts.

Counterpart of ``mnasnet_tpu/serving.py``. ``python -m
mnasnet_tpu_torch.tools.export_serving`` writes the artifact (the eval-mode
forward with its weights, optionally a symbolic batch); :func:`load_serving`
loads it once and serves it through a batch-routed callable that runs each
incoming batch size on the route measured fastest for it on the card
(``utils/routing.py``: eager, a CUDA graph, or ``torch.compile``).

    from mnasnet_tpu_torch.serving import load_serving
    predict = load_serving("model.pt2")           # path, bytes, or ExportedProgram
    logits = predict(images)                      # float32 [b, num_classes]

The artifact calls the port's kernels as the ``torch.library`` ops
``mnasnet_tpu_torch::dw_conv_bn_act`` and ``mnasnet_tpu_torch::mbconv_block``,
so loading it needs this package: this module imports the op registrations
before ``torch.export.load`` (without them the load fails to resolve the
ops), and the first call on the card builds the kernel sources
(``mnasnet_tpu_torch/csrc``) with ``nvcc``.
"""

from __future__ import annotations

import io
import os

import torch

# The ops' registrations: torch.export.load resolves the artifact's calls
# through them, and their CUDA impls count the launches.
from mnasnet_tpu_torch.ops.cuda import dw_conv, mbconv  # noqa: F401
from mnasnet_tpu_torch.models.mnasnet import resolve_device
from mnasnet_tpu_torch.utils.routing import ROUTES, BatchRouted


def load_serving(artifact, *, route: str = "auto", device="cuda") -> BatchRouted:
    """Load a serving artifact and return its batch-routed predict callable.

    ``artifact`` is a path to the file, its bytes, or a
    ``torch.export.ExportedProgram``. The program moves to ``device``
    (``torch.export.passes.move_to_device_pass``), so one artifact serves on
    the card and on the CPU; ``device="cuda"`` without a card raises.
    ``route``: ``"auto"`` routes each batch size by
    :func:`~mnasnet_tpu_torch.utils.routing.default_route` (eager off the
    card); ``"eager"``, ``"graph"`` or ``"compile"`` runs every batch size on
    that route. The callable takes the artifact's call contract (images,
    float32 or uint8 for ``--raw-input`` exports, as a tensor on any device
    or a numpy array) and returns float32 logits on ``device``; with a
    symbolic-batch artifact every batch size works, and a fixed-batch one
    raises for any other.
    """
    if route != "auto" and route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; choices: auto, {', '.join(ROUTES)}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # The program's device arguments name the card by index, as the
        # tensors a compile traces do.
        dev = torch.device("cuda", torch.cuda.current_device())
    if isinstance(artifact, (str, os.PathLike)):
        artifact = torch.export.load(artifact)
    elif isinstance(artifact, (bytes, bytearray)):
        artifact = torch.export.load(io.BytesIO(bytes(artifact)))
    from torch.export.passes import move_to_device_pass

    module = move_to_device_pass(artifact, dev).module()

    @torch.no_grad()
    def predict(images):
        return module(images)

    route_for = None if route == "auto" else (lambda bs: route)
    return BatchRouted(predict, batch_arg=0, route_for=route_for, device=dev)
