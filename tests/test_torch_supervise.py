"""The port's restart supervisor (``mnasnet_tpu_torch/tools/supervise.py``),
the counterpart of ``tools/supervise.py``, with the four cases of
tests/test_supervise.py on the port's checkpoint layout and CLI: the output
directory, what counts as a checkpoint, the ``--resume`` logic, and a
restart after a crash (a fake trainer as the child)."""

import sys

from mnasnet_tpu_torch.tools import supervise
from mnasnet_tpu_torch.train.checkpoint import FILE


def _key(directory):
    directory.mkdir(parents=True)
    (directory / FILE).write_bytes(b"")


def test_parse_output_dir():
    assert supervise.parse_output_dir(["--epochs", "2", "--output-dir", "/x/y"]) == "/x/y"
    assert supervise.parse_output_dir(["--output-dir=/a"]) == "/a"
    assert supervise.parse_output_dir(["--epochs", "2"]) == "checkpoints"


def test_has_checkpoint(tmp_path):
    out = tmp_path / "run"
    assert not supervise.has_checkpoint(str(out))
    out.mkdir()
    (out / "best").mkdir()  # a name that is not a key does not count
    (out / ".tmp-0-123").mkdir()  # nor a write in progress
    assert not supervise.has_checkpoint(str(out))
    (out / "preempt").mkdir()  # nor an empty preempt/
    (out / "3").mkdir()  # nor a key without its file
    assert not supervise.has_checkpoint(str(out))
    _key(out / "preempt" / "7")
    assert supervise.has_checkpoint(str(out))
    (out / "preempt" / "7" / FILE).unlink()
    _key(out / "0")
    assert supervise.has_checkpoint(str(out))


def test_build_cmd_resume_logic(tmp_path):
    out = tmp_path / "run"
    args = ["--epochs", "2", "--output-dir", str(out)]
    cmd = supervise.build_cmd(args, str(out))
    assert cmd[:3] == [sys.executable, "-m", "mnasnet_tpu_torch.train"]
    assert "--resume" not in cmd  # nothing to restore: the trainer would refuse it
    _key(out / "0")
    assert supervise.build_cmd(args, str(out))[-2:] == ["--resume", str(out)]
    # a --resume of the caller's own is never doubled
    assert supervise.build_cmd([*args, "--resume", "/elsewhere"], str(out)).count("--resume") == 1
    assert supervise.build_cmd([*args, "--resume=/e"], str(out))[-1] == "--resume=/e"
    # one process a card under torchrun
    cmd = supervise.build_cmd(args, str(out), nproc_per_node=4)
    assert cmd[1:8] == ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                        "4", "-m", "mnasnet_tpu_torch.train"]
    assert cmd[-2:] == ["--resume", str(out)]


FAKE_TRAINER = '''
import os, sys
from mnasnet_tpu_torch.train.checkpoint import FILE
args = sys.argv[1:]
out = args[args.index("--output-dir") + 1]
with open(os.path.join(os.path.dirname(out), "attempts.log"), "a") as log:
    log.write(" ".join(args) + "\\n")
if "--resume" not in args:
    os.makedirs(os.path.join(out, "0"))
    open(os.path.join(out, "0", FILE), "wb").close()
    sys.exit(7)  # a crash after the first epoch's checkpoint
sys.exit(0)
'''


def test_supervisor_restarts_after_a_crash_with_resume(tmp_path, monkeypatch, capfd):
    (tmp_path / "fake_trainer.py").write_text(FAKE_TRAINER)
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{':'.join(sys.path)}")
    out = tmp_path / "run"
    rc = supervise.main(["--max-restarts", "3", "--", "--epochs", "2", "--output-dir",
                         str(out)], module="fake_trainer")
    assert rc == 0
    attempts = (tmp_path / "attempts.log").read_text().splitlines()
    assert attempts == [f"--epochs 2 --output-dir {out}",
                        f"--epochs 2 --output-dir {out} --resume {out}"]
    text = capfd.readouterr().out
    assert "attempt 1 exited 7" in text and "restarting from checkpoint" in text
    assert "attempt 2 completed" in text


def test_supervisor_gives_up_on_a_crash_loop(tmp_path, monkeypatch, capfd):
    (tmp_path / "crashing.py").write_text("import sys; sys.exit(3)\n")
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{':'.join(sys.path)}")
    rc = supervise.main(["--max-restarts", "2", "--", "--output-dir", str(tmp_path / "o")],
                        module="crashing")
    assert rc == 3
    assert "2 consecutive fast failures" in capfd.readouterr().out
