"""Work of an EfficientNet's four squeeze-and-excitation kernels in
training, one entry a launch over each block's SE plane (the dw conv's
output): the pool reads x and writes the (N, C) means (counted as fp32); the
scale reads x and writes y; the gate gradient reads g and x; the dx pass
reads g and writes dx. One operation an element (pool, scale) or two (gate
gradient, dx). No launches for any other architecture or phase."""

from benchmark import counting
from benchmark import counting_efficientnet


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "train" or not counting_efficientnet.is_efficientnet(config):
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for _, h, _, c, _, k, s, _ in counting_efficientnet.block_shapes(config):
        ho = counting.out_size(h, k, s)
        n = batch * ho * ho * c
        shape = (batch, ho, ho, c)
        out += [(shape + ("pool",), n * e + batch * c * 4, n),
                (shape + ("scale",), 2 * n * e, n),
                (shape + ("dgate",), 2 * n * e, 2 * n),
                (shape + ("dx",), 2 * n * e, 2 * n)]
    return out
