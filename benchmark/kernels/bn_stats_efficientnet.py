"""Work of an EfficientNet's BN statistics pass: x read once, the (2, C)
fp32 sums written; 3 operations an element. No launches for any other
architecture."""

from benchmark import counting_efficientnet as counting


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "train" or not counting.is_efficientnet(config):
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for _, h, c in counting.bn_region_shapes(config):
        n = batch * h * h * c
        out.append(((batch, h, h, c), n * e + 2 * c * 4, 3 * n))
    return out
