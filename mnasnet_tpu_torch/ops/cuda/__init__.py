"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), built with ``nvcc`` at
first use and bound with ``ctypes``. Each wrapper runs its plain PyTorch
version for a CPU tensor and its kernel for a CUDA tensor, as a
``torch.library`` op (``mnasnet_tpu_torch::dw_conv_bn_act``, ``::mbconv_block``,
``::bn_bwd_reduce``, ``::bn_bwd_dx``) with a CPU, a CUDA and a fake impl."""

from mnasnet_tpu_torch.ops.cuda.bn_bwd import (  # noqa: F401
    bn_bwd_dx,
    bn_bwd_reduce,
    bn_relu_train,
)
from mnasnet_tpu_torch.ops.cuda.dw_conv import (  # noqa: F401
    depthwise_conv_train,
    dw_conv_bn_act,
    dw_conv_reference,
)
from mnasnet_tpu_torch.ops.cuda.mbconv import (  # noqa: F401
    mbconv_fits_smem,
    mbconv_fused,
    mbconv_reference,
)
