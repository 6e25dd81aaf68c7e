"""Work of the BN+SiLU apply: x read and y written once, four fp32 vectors;
8 operations an element (the affine's two, SiLU's exponential, add and
division, counted as one each, and the two roundings' compares). No
launches for any other architecture."""

from benchmark import counting_efficientnet as counting


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "train" or not counting.is_efficientnet(config):
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for _, h, c in counting.bn_region_shapes(config):
        n = batch * h * h * c
        out.append(((batch, h, h, c), 2 * n * e + 4 * c * 4, 8 * n))
    return out
