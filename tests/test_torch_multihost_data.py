"""The port's train CLI over on-disk JPEG trees, with real processes, on the
CPU: the counterparts of the reference's ``tools/multihost_data.py``,
``multihost_recal.py`` and ``dress_rehearsal.py`` at a small size (the
trees of ``dress_rehearsal.make_tree``: 10 or 20 classes, one CMYK file).

Bars, each the tool's (see its docstring for the reason):
  * two ranks over a tree: each train index consumed once by one rank
    (only the ``drop_last`` tail left out), val covered exactly once, the
    CMYK file's decoder fallback counted exactly once across the ranks,
    two runs bit for bit;
  * recalibration over two ranks: the weights untouched bit for bit, the
    statistics within 1e-5 + 1e-4·|b| of one process's over the same
    global batches (fp32), the reference's bar;
  * the dress rehearsal: one fallback, a lexicographic and stable class
    mapping, an epoch and the eval CLI's score of its checkpoint.
The native decoder builds here (``g++``, ``libjpeg``); the tools' defaults
(the reference's sizes, up to 1000 classes) run only with ``RUN_SLOW`` set,
as ``tests/test_multihost.py`` gates its own.
"""

import json
import os
import subprocess
import sys

import pytest

from mnasnet_tpu_torch.tools import dress_rehearsal, multihost, multihost_data, multihost_recal


def test_two_ranks_over_an_on_disk_tree(tmp_path):
    out = multihost_data.data_run(tmp_path, n_classes=20, batch_size=8)
    assert out["files_seen_once"]["ok"], out["files_seen_once"]
    assert out["cmyk_fallback_total_across_ranks"] == 1
    assert out["rerun_bitwise_identical"], out["mismatches"]
    assert out["ok"]


def test_recalibration_over_two_ranks_against_one_process(tmp_path):
    out = multihost_recal.recal_run(tmp_path, n_classes=10, batch_size=8, recal_batches=2)
    assert out["params_bitwise_unchanged"], out["params_mismatches"]
    assert out["stats_match"], out["oracle"]
    assert out["ok"]


def test_dress_rehearsal(tmp_path):
    out = dress_rehearsal.rehearse(tmp_path, n_classes=20, image_size=64, batch_size=8)
    assert out["ok"], out
    assert out["decoder_fallback_count"] == 1


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="the reference's sizes (minutes each); set RUN_SLOW=1")
@pytest.mark.parametrize("tool", ["multihost_data", "multihost_recal", "dress_rehearsal"])
def test_tool_full_size(tool, tmp_path):
    out = tmp_path / "out.json"
    r = subprocess.run([sys.executable, "-m", f"mnasnet_tpu_torch.tools.{tool}", "--out",
                        str(out)], cwd=multihost.REPO, env=multihost.child_env(), timeout=7200)
    assert r.returncode == 0 and json.loads(out.read_text())["ok"]
