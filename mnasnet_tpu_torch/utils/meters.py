"""AverageMeter / ProgressMeter: the reference's batch-time vs data-time
split, the data-starvation diagnostic. A copy of
``mnasnet_tpu/utils/meters.py``; the printed format is the reference's,
since users grep it. Device metrics arrive as tensors and are read only
when a meter is updated."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running average, sum, count."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg
        )


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        num_digits = len(str(num_batches // 1))
        self.batch_fmtstr = "[{:" + str(num_digits) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)
