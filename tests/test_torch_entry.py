"""The port's driver entry points (``mnasnet_tpu_torch/entry.py``), the
counterpart of the root ``__graft_entry__.py``, on the CPU: the forward
``entry`` returns, the dry run over two and four gloo ranks (with the
reference's ``dcn × dp`` and ``dp × sp`` meshes), and the refusal of a dry
run on cards this machine does not have."""

import math
import re

import pytest
import torch

from mnasnet_tpu_torch.entry import dryrun_multichip, entry


def test_entry_forward_gives_the_flagship_logits():
    forward, args = entry(device="cpu")
    (images,) = args
    assert images.shape == (8, 224, 224, 3) and images.dtype == torch.bfloat16
    logits = forward(*args)
    assert logits.shape == (8, 1000) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_dryrun_over_two_gloo_ranks_takes_both_steps(capfd):
    """Each rank asserts ``step == 1`` and a finite loss after each step and
    raises otherwise; rank 0 prints one line per step."""
    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    for line in (r"dryrun dp\(2x1\): ok, loss=(\S+) \(eager route\)",
                 r"dryrun dp local-BN\(2x1\): ok, loss=(\S+) \(eager route\)",
                 r"dryrun dp x sp\(1x2\): ok, loss=(\S+) \(eager route\)",
                 r"dryrun_multichip\(2\): ok, loss=(\S+)"):
        m = re.search(line, out)
        assert m, out
        assert math.isfinite(float(m.group(1)))
    assert "production-shape capture: not made on the CPU" in out


def test_dryrun_over_four_gloo_ranks_takes_the_mesh_steps(capfd):
    """At world 4 the reference's ``dcn x dp(2x2)`` and ``dp x sp(2x2)``
    lines (``__graft_entry__.py:148-162,193-208``), each from a real step
    through the ``Trainer`` on its mesh: the spatial one with each rank on
    16 of the 32 image rows, its halo exchanges over its spatial group."""
    dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    losses = []
    for line in (r"dryrun dp\(4x1\): ok, loss=(\S+) \(eager route\)",
                 r"dryrun dcn x dp\(2x2\): ok, loss=(\S+) \(eager route\)",
                 r"dryrun dp x sp\(2x2\): ok, loss=(\S+) \(eager route\)"):
        m = re.search(line, out)
        assert m, out
        losses.append(float(m.group(1)))
    assert "dryrun dp x sp band plan (plane rows: rows a band): " \
        "32:16/16 16:8/8 8:4/4 4:2/2 2:1/1 1:1/0" in out
    # The same images and weights: the meshes change only where rows lie.
    assert all(math.isfinite(v) for v in losses) and len(set(losses)) == 1, losses


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_on_more_cards_than_the_machine_has_raises(n):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= n:
        pytest.skip(f"this machine has {have} cards")
    with pytest.raises(RuntimeError, match=f"needs {n} CUDA devices, this machine has {have}"):
        dryrun_multichip(n, device="cuda")
