"""Work of the fused MBConv op: the block's input read once and its output
written once, the three weights read once in the compute type, the six
fp32 BN vectors; 2 operations a multiply-accumulate of the expand, the
depthwise and the project."""

from benchmark import counting


def launches(config: dict, batch: int, phase: str) -> list[tuple]:
    if phase != "serve":
        return []
    e = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for _, h, cin, cmid, cout, k, s in counting.block_shapes(config):
        ho = counting.out_size(h, k, s)
        nbytes = ((batch * h * h * cin + batch * ho * ho * cout) * e
                  + (cin * cmid + k * k * cmid + cmid * cout) * e
                  + (4 * cmid + 2 * cout) * 4)
        flops = 2 * batch * (h * h * cin * cmid + ho * ho * (k * k * cmid + cmid * cout))
        out.append(((batch, h, h, cin, cmid, cout, k, s), nbytes, flops))
    return out
