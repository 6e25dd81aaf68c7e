"""Work of the BN+SiLU backward's reduce: x and dy read once, six fp32
vectors; 16 operations an element (the reduce's 8, and z and SiLU's
derivative recomputed). No launches for any other architecture."""

from benchmark import counting_efficientnet as counting


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "train" or not counting.is_efficientnet(config):
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for _, h, c in counting.bn_region_shapes(config):
        n = batch * h * h * c
        out.append(((batch, h, h, c), 2 * n * e + 6 * c * 4, 16 * n))
    return out
