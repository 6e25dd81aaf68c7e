"""The multi-process proofs of the port's train CLI on the CPU (gloo ranks
as real processes, ``mnasnet_tpu_torch/tools/multihost.py``): the
counterparts of the reference's ``tools/multihost_smoke.py`` and
``multihost_preempt.py``, each at a small size here; those over on-disk
JPEG trees are in ``tests/test_torch_multihost_data.py``.

Bars, each the tool's (see its docstring for the reason):
  * two ranks twice, and a resume of the epoch checkpoint against the
    uninterrupted run: bit for bit (model, optimizer, step, generator);
  * one step of two ranks against one process on the same global batch:
    rtol 1e-5, atol 1e-6 plus 25 times the one-process step's own move
    under a one-ulp change of its images (``tests/test_torch_parallel.py``'s
    bound); bitwise is not expected, the sums are grouped otherwise;
  * a SIGTERM to rank 1 alone: both ranks stop before the same step (each
    rank's step in ``preempt/meta.json``), exit 0, and the resumed run is
    bit for bit the uninterrupted one.
The tools' defaults (the reference's sizes) run only with ``RUN_SLOW`` set,
as ``tests/test_multihost.py`` gates its own.
"""

import json
import os
import subprocess
import sys

import pytest

from mnasnet_tpu_torch.tools import multihost, multihost_preempt, multihost_smoke


def test_two_ranks_bitwise_rerun_and_resume_and_one_step_against_one_process(tmp_path):
    out = multihost_smoke.smoke(multihost.small_flags(32), tmp_path)
    assert out["rerun_bitwise_identical"], out["rerun_mismatches"]
    assert out["resume_bitwise_identical"], out["resume_mismatches"]
    vs = out["one_step_vs_single_process"]
    assert vs["held"], vs
    assert vs["bitwise_leaves"] < vs["leaves"]  # the grouping differs: not a copy
    assert out["ok"] and out["steps"] == 4


def test_sigterm_to_one_rank_stops_both_at_one_step_and_resumes_bitwise(tmp_path):
    out = multihost_preempt.preempt(multihost.small_flags(16 * multihost_preempt.STEPS_PER_EPOCH),
                                    tmp_path, epochs=2)
    assert out["ok"], out
    spe = out["steps_per_epoch"]
    assert spe < out["stop_step"] < 2 * spe  # mid-epoch 1
    assert out["steps_by_rank"] == [out["stop_step"]] * 2
    assert out["interrupted_vs_uninterrupted"]["bitwise_match"]


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="the reference's sizes (minutes each); set RUN_SLOW=1")
@pytest.mark.parametrize("tool", ["multihost_smoke", "multihost_preempt"])
def test_tool_full_size(tool, tmp_path):
    out = tmp_path / "out.json"
    r = subprocess.run([sys.executable, "-m", f"mnasnet_tpu_torch.tools.{tool}", "--out",
                        str(out)], cwd=multihost.REPO, env=multihost.child_env(), timeout=7200)
    assert r.returncode == 0 and json.loads(out.read_text())["ok"]
