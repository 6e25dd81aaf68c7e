"""mfu.serve: 2 x the frozen MACs an image x the images served a second
(serve_images_per_s of the run's timed window, host clock), over the bf16
peak of the card."""

from benchmark.roofline import mfu


def read(r):
    return mfu(r, "serve_images_per_s", 2) if r.phase == "serve" else None
