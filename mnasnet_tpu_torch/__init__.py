"""mnasnet_tpu_torch — the PyTorch and CUDA port of mnasnet_tpu for NVIDIA Hopper.

The eval-mode forward of the MNASNet-B1 depth-multiplier family, with
hand-written CUDA kernels for the fused depthwise conv and the fused MBConv
block. It never imports JAX or the ``mnasnet_tpu`` package, which stays the
reference. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from mnasnet_tpu_torch.models.mnasnet import (
    MNASNet,
    create_model,
    get_depths,
    mnasnet0_35,
    mnasnet0_5,
    mnasnet0_75,
    mnasnet1_0,
    mnasnet1_3,
    mnasnet1_4,
    MODEL_REGISTRY,
)
from mnasnet_tpu_torch.pretrained import load_pretrained

__version__ = "0.1.0"

__all__ = [
    "MNASNet",
    "create_model",
    "get_depths",
    "mnasnet0_35",
    "mnasnet0_5",
    "mnasnet0_75",
    "mnasnet1_0",
    "mnasnet1_3",
    "mnasnet1_4",
    "MODEL_REGISTRY",
    "load_pretrained",
    "__version__",
]
