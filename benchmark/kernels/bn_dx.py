"""Work of the BN backward's dx: x and dy read and dx written once, six
fp32 vectors; 10 operations an element."""

from benchmark import counting


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "train":
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for _, h, c in counting.bn_region_shapes(config):
        n = batch * h * h * c
        out.append(((batch, h, h, c), 3 * n * e + 6 * c * 4, 10 * n))
    return out
