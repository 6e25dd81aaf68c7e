"""mfu.train_efficientnet: 6 x the frozen MACs an image of an EfficientNet
(``counting_efficientnet.count_macs``) x the images stepped a second
(train_images_per_s of the run's timed window, host clock), over the bf16
peak of the cell's cards."""

from benchmark import counting, counting_efficientnet


def read(r):
    rate = r.e2e.get("train_images_per_s")
    if r.phase != "train" or not rate or not counting_efficientnet.is_efficientnet(r.config):
        return None
    macs = counting_efficientnet.count_macs(r.config)
    return 100.0 * 6 * macs * rate / (counting.PEAK_FLOPS["bfloat16"] * r.chips)
