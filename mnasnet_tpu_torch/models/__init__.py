from mnasnet_tpu_torch.models.mnasnet import (  # noqa: F401
    MNASNet,
    InvertedResidual,
    create_model,
    count_macs,
    get_depths,
    round_to_multiple_of,
    mnasnet0_35,
    mnasnet0_5,
    mnasnet0_75,
    mnasnet1_0,
    mnasnet1_3,
    mnasnet1_4,
    MODEL_REGISTRY,
    BASE_DEPTHS,
    STACKS,
)
from mnasnet_tpu_torch.models.layers import BatchNorm  # noqa: F401
