"""Work of the BN+SiLU backward's dx: x and dy read and dx written once,
eight fp32 vectors; 18 operations an element (the dx pass's 10, and z and
SiLU's derivative recomputed). No launches for any other architecture."""

from benchmark import counting_efficientnet as counting


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "train" or not counting.is_efficientnet(config):
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for _, h, c in counting.bn_region_shapes(config):
        n = batch * h * h * c
        out.append(((batch, h, h, c), 3 * n * e + 8 * c * 4, 18 * n))
    return out
