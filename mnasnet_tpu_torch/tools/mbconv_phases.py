"""Where the bf16 MBConv kernel's time goes, phase by phase, on the card.

    python -m mnasnet_tpu_torch.tools.mbconv_phases [--arch mnasnet1_0]

Builds ``csrc/mbconv.cu`` with ``-DMBCONV_PHASE_CLOCKS`` into
``build/kernels/``, which turns on its ``PHASE_MARK`` clocks: thread 0 of
every block reads ``clock64()`` at the end of each phase and adds the cycles
since its previous reading to that phase's counter. For each MBConv block of
the model at 224 px, batch 128, it launches the kernel with the planner's
plan and prints the cycles per block of each phase: staging
(x halo and first chunk issued, mid zeroed), the previous chunk's project
and the barrier after it, the next chunk's issue and the wait for the
current one, expand, depthwise, and the last chunk's project with the
epilogue. A phase's cycles are the slowest warp's, as thread 0 sees them at
the barrier. The counters cost a few instructions per phase; the kernel's
time is printed beside them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from mnasnet_tpu_torch.models.mnasnet import arch_alpha
from mnasnet_tpu_torch.ops.cuda import _build, mbconv
from mnasnet_tpu_torch.tools.tune_plans import BATCH, block_shapes, random_block, time_ms

PHASES = ("stage", "project + barrier", "issue + wait", "expand", "depthwise",
          "last project + epilogue")


def build() -> ctypes.CDLL:
    """``csrc/mbconv.cu`` built with its phase clocks on (``PHASE_MARK``)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "libmbconv_phases.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DMBCONV_PHASE_CLOCKS", "-o",
                          str(lib), str(_build.CSRC_DIR / "mbconv.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on mbconv.cu with its phase clocks:\n{out.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.mbconv_block.argtypes, cdll.mbconv_block.restype = mbconv._PROTOTYPES["mbconv_block"]
    cdll.mbconv_phase_cycles.argtypes = [ctypes.c_void_p]
    return cdll


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mnasnet1_0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mbconv_phases needs a CUDA device")
    lib = build()
    cycles = (ctypes.c_ulonglong * 8)()
    g = torch.Generator(device="cuda").manual_seed(2)
    for name, h, cin, cmid, cout, k, s in block_shapes(arch_alpha(args.arch)):
        _, block_args, kw = random_block(h, cin, cmid, cout, k, s, g)
        block_args = (block_args[0].to(torch.bfloat16),) + block_args[1:]
        ops = mbconv.kernel_args(*block_args, kernel_size=k)
        p = mbconv.plan(h, h, cin, cmid, cout, k, s, 2)
        ho = mbconv.out_size(h, k, s)
        y = torch.empty((BATCH, ho, ho, cout), dtype=torch.bfloat16, device="cuda")

        def call():
            err = lib.mbconv_block(
                *(t.data_ptr() for t in ops), y.data_ptr(), BATCH, h, h, cin, cmid, cout, k, s,
                int(kw["residual"]), 1, p.th, p.tw, p.mc, p.threads,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mbconv_block failed with cudaError_t {err}")

        ms = time_ms(call, 30.0, graph=True)
        lib.mbconv_phase_cycles(cycles)
        call()
        torch.cuda.synchronize()
        lib.mbconv_phase_cycles(cycles)
        blocks = BATCH * -(-ho // p.th) * -(-ho // p.tw)
        per = [cycles[i] / blocks for i in range(len(PHASES))]
        total = sum(per)
        print(f"{name} {h}x{h} {cin}->{cmid}->{cout} k{k} s{s} plan {tuple(p[:3])}: {ms:.4f} ms, "
              f"{blocks} blocks, {-(-cmid // p.mc)} chunks, {total:.0f} cycles/block: "
              + ", ".join(f"{n} {v:.0f} ({v / total:.0%})" for n, v in zip(PHASES, per)),
              flush=True)


if __name__ == "__main__":
    main()
