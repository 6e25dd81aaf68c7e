"""mfu.train: 6 x the frozen MACs an image x the images stepped a second
(train_images_per_s of the run's timed window, host clock), over the bf16
peak of the cell's cards."""

from benchmark.roofline import mfu


def read(r):
    return mfu(r, "train_images_per_s", 6) if r.phase == "train" else None
