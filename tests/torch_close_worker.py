"""One NCCL rank that raises after its train step captured the group's
collectives, with ``parallel.close`` in a ``finally`` as the train CLI
(``train/__main__.py:main``) and the dry run (``entry.py:_rank``) call it:
while ``close`` runs, the exception's traceback keeps the step and its CUDA
graph alive. ``tests/test_torch_gpu.py`` starts one per card and holds each
to an exit within a bound:

    PYTHONPATH=. python tests/torch_close_worker.py RANK WORLD RENDEZVOUS_FILE

It prints how many graphs the replicas registered, then ``closed`` once
``close`` has returned; the exception then ends the process with code 1.
"""

import sys

import torch
import torch.distributed as dist

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.models.layers import set_replicas
from mnasnet_tpu_torch.parallel import Replicas, close
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_train_step


class Raised(RuntimeError):
    """The exception raised past the capture."""


def _train(replicas: Replicas) -> None:
    dev = replicas.device
    model = create_model("mnasnet0_35", device=dev, num_classes=10, bn_ema="external",
                         stem_s2d=True, seed=0)
    tx = create_optimizer("rmsprop", 1e-3, fused="small")
    state = TrainState.create(model, tx)
    set_replicas(model, replicas)
    step = make_train_step(model, tx, 0.1, replicas=replicas, route="graph")
    g = torch.Generator(device=dev).manual_seed(replicas.rank)
    images = torch.randn(4, 64, 64, 3, device=dev, generator=g)
    labels = torch.randint(0, 10, (4,), device=dev, generator=g)
    for _ in range(2):  # the warm-up and the capture, then one replay
        state, _ = step(state, images, labels)
    torch.cuda.synchronize()
    print(f"rank {replicas.rank}: {sum(step.replays.values())} replay, "
          f"{len(replicas._graphs)} graph registered", flush=True)
    raise Raised("raised past the capture")


def main(rank: int, world: int, rendezvous: str) -> None:
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", world_size=world,
                            rank=rank)
    replicas = Replicas(rank, world, dev)
    try:
        _train(replicas)
    finally:
        close(replicas)
        print(f"rank {rank}: closed", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
