"""Run one cell of the benchmark once and print its result's line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``mnasnet_tpu_torch``)
and ``BENCHMARK.json``. The run makes its weights and inputs on the card
from ``--seed``, sets up and warms only the cell's shapes, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of its standard
output: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics from a traced window after the timed one, with the
breakdown. Each number compared and its limit are the last lines of its
standard error and the last key of the line.

It exits with code 3 and prints no result where the cell's cards are not
there, and with code 4 where JAX or the JAX package is loaded once the
window has closed.
"""

import time

T0 = time.perf_counter()  # the set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mnasnet_tpu"}


def forbidden_modules(names=None) -> list[str]:
    """Of ``names`` (default: the loaded modules), the top-level names,
    compared whole, that are JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)}
                  & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # The program's route override would take another path than the one
    # users get; the benchmark measures the program's own choice.
    os.environ.pop("MNASNET_TPU_TORCH_ROUTE", None)

    import torch

    from benchmark import registry
    from benchmark.harness import run_cell

    # One thread of the CPU's operator pool: the timed paths run on the card.
    torch.set_num_threads(1)
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3
    from benchmark.common import card_line

    print(f"card: {card_line(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    result = run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0), t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad} (JAX or the JAX package)", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
