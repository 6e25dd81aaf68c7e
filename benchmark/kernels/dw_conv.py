"""Work of the depthwise conv op: x read once, y written once, the fp32
weights, scale and bias read once; 2 k^2 operations an output element."""

from benchmark import counting


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    """(shape, bytes, flops) of each launch of one forward (serve) or one
    training step (train)."""
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    shapes = counting.dw_shapes(config)
    if phase == "serve":
        shapes = shapes[:1]
    elif phase != "train":
        return []
    out = []
    for h, c, k, s in shapes:
        ho = counting.out_size(h, k, s)
        nbytes = (batch * h * h * c + batch * ho * ho * c) * e + (k * k + 2) * c * 4
        out.append(((batch, h, h, c, k, s), nbytes, 2 * k * k * batch * ho * ho * c))
    return out
