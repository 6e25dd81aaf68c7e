from mnasnet_tpu_torch.ops.depthwise import (  # noqa: F401
    depthwise_conv2d,
    depthwise_conv_bn_relu_fused,
)
