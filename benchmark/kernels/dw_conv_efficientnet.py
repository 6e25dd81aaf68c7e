"""Work of an EfficientNet's depthwise conv op in training: x read once, y
written once, the fp32 weights, scale and bias read once; 2 k^2
operations an output element. No launches for any other architecture."""

from benchmark import counting
from benchmark import counting_efficientnet


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "train" or not counting_efficientnet.is_efficientnet(config):
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for h, c, k, s in counting_efficientnet.dw_shapes(config):
        ho = counting.out_size(h, k, s)
        nbytes = (batch * h * h * c + batch * ho * ho * c) * e + (k * k + 2) * c * 4
        out.append(((batch, h, h, c, k, s), nbytes, 2 * k * k * batch * ho * ho * c))
    return out
