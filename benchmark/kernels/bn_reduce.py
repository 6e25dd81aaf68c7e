"""Work of the BN backward's reduce: x and dy read once, six fp32 vectors;
8 operations an element."""

from benchmark import counting


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "train":
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for _, h, c in counting.bn_region_shapes(config):
        n = batch * h * h * c
        out.append(((batch, h, h, c), 2 * n * e + 6 * c * 4, 8 * n))
    return out
