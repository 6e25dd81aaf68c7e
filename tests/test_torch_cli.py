"""The PyTorch port's CLIs, ``python -m mnasnet_tpu_torch.train`` and
``python -m mnasnet_tpu_torch.eval``, through the argv a user types, with
``--device cpu``: the counterparts of tests/test_cli_e2e.py and
tests/test_preempt.py. ``main(argv)`` runs in-process, as the reference's
tests run train.py, so that a step callback can deliver SIGTERM."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mnasnet_tpu_torch.train import __main__ as train_cli
from mnasnet_tpu_torch.train.checkpoint import CheckpointManager
from mnasnet_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
# 24 samples at batch 8: 3 steps per epoch; the val set is one batch.
BASE = [
    "--synthetic", "--arch", "mnasnet0_35", "--num-classes", "8", "--image-size", "32",
    "--batch-size", "8", "--synthetic-size", "24", "--workers", "0", "--print-freq", "100",
    "--dtype", "float32", "--seed", "0", "--device", "cpu",
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def _latest_payload(out):
    key = CheckpointManager(str(out)).latest_epoch()
    return torch.load(out / str(key) / "checkpoint.pt", weights_only=True)


def _variables(out, **kw):
    return CheckpointManager(str(out)).restore_variables(**kw)


def _assert_same_weights(a, b):
    sa, ea, _ = _variables(a)
    sb, eb, _ = _variables(b)
    assert ea == eb and sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _with(argv, flag, value):
    argv = list(argv)
    argv[argv.index(flag) + 1] = str(value)
    return argv


def test_cli_train_writes_checkpoint_then_resume_evaluate(tmp_path, capsys):
    """best/ is written when acc1 beats the best so far (0 at the start), as
    in the reference: at seed 1 the epoch scores 12.5, at seed 0 it scores 0
    and writes no best/."""
    out = tmp_path / "run"
    train_cli.main([*_with(BASE, "--seed", 1), "--epochs", "1", "--output-dir", str(out)])
    text = capsys.readouterr().out
    assert "epoch 0: acc1=12.500" in text and "best=12.500 *" in text
    assert sorted(os.listdir(out)) == ["0", "best"] and os.listdir(out / "best") == ["0"]
    train_cli.main([*_with(BASE, "--seed", 1), "--epochs", "1", "--output-dir", str(out),
                    "--resume", str(out), "--evaluate"])
    text = capsys.readouterr().out
    assert "resumed from epoch 0 (best acc1 12.500)" in text and " * Acc@1 12.500" in text

    train_cli.main([*BASE, "--epochs", "1", "--output-dir", str(tmp_path / "zero")])
    assert "epoch 0: acc1=0.000" in capsys.readouterr().out
    assert os.listdir(tmp_path / "zero") == ["0"]


def test_cli_bn_recalibrate_saves_key_epochs(tmp_path, capsys):
    out = tmp_path / "run"
    train_cli.main([*BASE, "--epochs", "1", "--bn-recalibrate", "2", "--model-ema", "0.9",
                    "--output-dir", str(out)])
    text = capsys.readouterr().out
    assert "[bn-recal] running stats recomputed over 2 batches" in text
    assert "bn-recalibrated: acc1=" in text and "(ema weights, ema-paired stats)" in text
    assert "epoch 0: acc1=" in text and "(ema; raw=" in text
    assert {"0", "1"} <= set(os.listdir(out))
    # The recalibrated statistics differ from the trained ones; the weights do not.
    a, _, _ = CheckpointManager(str(out)).restore_variables(epoch=0)
    b, _, _ = CheckpointManager(str(out)).restore_variables(epoch=1)
    assert torch.equal(a["classifier.1.weight"], b["classifier.1.weight"])
    assert not torch.equal(a["layers.1.running_var"], b["layers.1.running_var"])


def _drain_pending_sigterm():
    """Let a SIGTERM still pending from a stopped run land under SIG_IGN, so
    that it cannot preempt the next run (see tests/test_preempt.py)."""
    prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    for _ in range(64):
        pass
    time.sleep(0.01)
    signal.signal(signal.SIGTERM, prev)


def _run_with_sigterm(monkeypatch, argv, after_steps=2):
    """Run the CLI with SIGTERM delivered to this process after step
    ``after_steps`` of each epoch, through the handler the CLI installs."""
    orig = Trainer.train_epoch

    def fire(state, gstep):
        os.kill(os.getpid(), signal.SIGTERM)

    def wrapped(self, state, loader, epoch, step_callback=None, step_callback_freq=0,
                start_step=0):
        return orig(self, state, loader, epoch, step_callback=fire,
                    step_callback_freq=after_steps, start_step=start_step)

    monkeypatch.setattr(Trainer, "train_epoch", wrapped)
    try:
        train_cli.main(argv)
    finally:
        monkeypatch.undo()
    _drain_pending_sigterm()


@pytest.mark.parametrize("extra", [[], ["--grad-accum", "2"], ["--model-ema", "0.9"]],
                         ids=["plain", "accum2", "ema"])
def test_cli_sigterm_preempt_save_resume_bitwise(tmp_path, capfd, monkeypatch, extra):
    argv = [*BASE, *extra, "--epochs", "2"]
    ref, pre = tmp_path / "ref", tmp_path / "pre"
    train_cli.main([*argv, "--output-dir", str(ref)])
    capfd.readouterr()

    before = signal.getsignal(signal.SIGTERM)
    _run_with_sigterm(monkeypatch, [*argv, "--output-dir", str(pre)])
    assert signal.getsignal(signal.SIGTERM) is before  # the CLI restores it
    cap = capfd.readouterr()
    assert "SIGTERM: finishing the in-flight step" in cap.err
    assert "preempted at global step 2" in cap.out and "epoch 0:" not in cap.out
    assert os.path.exists(pre / "preempt" / "meta.json")
    assert sorted(os.listdir(pre / "preempt")) == ["2", "meta.json"]

    train_cli.main([*argv, "--output-dir", str(pre), "--resume", str(pre)])
    text = capfd.readouterr().out
    assert "resumed from preemption checkpoint: epoch 0 step 2" in text
    assert "epoch 0:" in text and "epoch 1:" in text
    a, b = _latest_payload(ref), _latest_payload(pre)
    _assert_tree_equal(a["model"], b["model"])
    _assert_tree_equal(a["optimizer"], b["optimizer"])
    _assert_tree_equal(a["train_state"], b["train_state"])


def test_cli_sigterm_at_epoch_boundary_saves_epoch_checkpoint(tmp_path, capfd, monkeypatch):
    """A stop that lands during the last batch of an epoch writes the normal
    epoch checkpoint (every batch ran), not a preempt/ entry."""
    argv = [*BASE, "--epochs", "2"]
    ref, pre = tmp_path / "ref", tmp_path / "pre"
    train_cli.main([*argv, "--output-dir", str(ref)])
    _run_with_sigterm(monkeypatch, [*argv, "--output-dir", str(pre)], after_steps=3)
    text = capfd.readouterr().out
    assert "preempted at the epoch-0 boundary" in text
    assert not os.path.exists(pre / "preempt") and os.path.exists(pre / "0")
    train_cli.main([*argv, "--output-dir", str(pre), "--resume", str(pre)])
    text = capfd.readouterr().out
    assert "resumed from epoch 0" in text and "epoch 1:" in text and "epoch 0:" not in text
    _assert_same_weights(ref, pre)


def test_cli_preempt_before_first_step_resumes(tmp_path, capfd, monkeypatch):
    """A stop before the first step writes preempt key 0, which --resume takes."""
    argv = [*BASE, "--epochs", "1"]
    ref, pre = tmp_path / "ref", tmp_path / "pre"
    train_cli.main([*argv, "--output-dir", str(ref)])
    orig = Trainer.train_epoch

    def wrapped(self, state, loader, epoch, step_callback=None, step_callback_freq=0,
                start_step=0):
        self.request_stop()
        return orig(self, state, loader, epoch, start_step=start_step)

    monkeypatch.setattr(Trainer, "train_epoch", wrapped)
    try:
        train_cli.main([*argv, "--output-dir", str(pre)])
    finally:
        monkeypatch.undo()
    assert "preempted at global step 0" in capfd.readouterr().out
    train_cli.main([*argv, "--output-dir", str(pre), "--resume", str(pre)])
    assert "resumed from preemption checkpoint: epoch 0 step 0" in capfd.readouterr().out
    _assert_same_weights(ref, pre)


def test_resume_refuses_missing_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint found"):
        train_cli.main([*BASE, "--epochs", "1", "--output-dir", str(tmp_path / "out"),
                        "--resume", str(tmp_path / "nonexistent")])


def test_resume_refuses_steps_per_epoch_mismatch(tmp_path, capfd, monkeypatch):
    """Refused only while the preempt checkpoint is the one resumed from."""
    out = tmp_path / "run"
    argv = [*BASE, "--epochs", "2", "--output-dir", str(out)]
    _run_with_sigterm(monkeypatch, argv)
    assert os.path.exists(out / "preempt" / "meta.json")
    with pytest.raises(SystemExit, match="steps_per_epoch"):
        train_cli.main([*_with(argv, "--batch-size", 4), "--resume", str(out)])
    train_cli.main([*argv, "--resume", str(out)])
    assert "resumed from preemption checkpoint: epoch 0 step 2" in capfd.readouterr().out
    # Now stale: an epoch-granular resume with a new batch size is legal.
    train_cli.main([*_with(argv, "--batch-size", 4), "--epochs", "3", "--resume", str(out)])
    assert "epoch 2:" in capfd.readouterr().out


def test_check_preempt_meta_tolerates_torn_or_missing(tmp_path):
    pre = tmp_path / "preempt"
    pre.mkdir()
    train_cli._check_preempt_meta(str(pre), 3)  # missing
    (pre / "meta.json").write_text("{truncated")
    train_cli._check_preempt_meta(str(pre), 3)  # torn: a warning
    (pre / "meta.json").write_text('{"steps_per_epoch": 3}')
    train_cli._check_preempt_meta(str(pre), 3)
    (pre / "meta.json").write_text('{"steps_per_epoch": 7, "global_batch": 8}')
    with pytest.raises(SystemExit, match="steps_per_epoch=7"):
        train_cli._check_preempt_meta(str(pre), 3)


@pytest.mark.parametrize("flags,message", [
    # The reference's refusals of a data-parallel layout (train.py:310-317,
    # 424-430), in one process; none joins a process group.
    (["--world-size", "2"], "--world-size 2 != the process group's 1"),
    (["--rank", "1"], "--rank 1 != this process's rank 0"),
    (["--mesh-dcn", "2", "--no-sync-bn"], "--mesh-dcn requires --sync-bn"),
    (["--grad-accum", "2", "--no-sync-bn"], "drop --no-sync-bn"),
    (["--dist-url", "tcp://localhost:1", "--world-size", "2", "--rank", "0", "--mesh-dcn",
      "3"], "--mesh-dcn 3 does not divide the world size 2"),
])
def test_cli_refuses_flags_whose_modules_are_not_ported(tmp_path, flags, message):
    with pytest.raises(SystemExit, match=message):
        train_cli.main([*BASE, *flags, "--output-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cli_remat_trains_and_its_checkpoint_resumes_without_it(tmp_path, capsys,
                                                                 monkeypatch):
    """``--remat`` trains (each block's body runs twice a step: the forward
    and the backward's recompute), and its epoch checkpoint resumes without
    ``--remat``: the state_dict is the same, and so is the step, so the
    resumed run ends bit for bit where a run with ``--remat`` throughout
    ends."""
    from mnasnet_tpu_torch.models.mnasnet import InvertedResidual

    bodies = []
    orig = InvertedResidual._train_body

    def counted(self, *a):
        bodies.append(1)
        return orig(self, *a)

    monkeypatch.setattr(InvertedResidual, "_train_body", counted)
    argv = _with(BASE, "--synthetic-size", 16)  # 2 steps an epoch
    whole, half = tmp_path / "whole", tmp_path / "half"
    train_cli.main([*argv, "--remat", "--epochs", "2", "--output-dir", str(whole)])
    assert len(bodies) == 16 * 2 * 4
    del bodies[:]
    train_cli.main([*argv, "--remat", "--epochs", "1", "--output-dir", str(half)])
    assert len(bodies) == 16 * 2 * 2
    del bodies[:]
    train_cli.main([*argv, "--epochs", "2", "--resume", str(half), "--output-dir", str(half)])
    assert len(bodies) == 16 * 2
    assert "Epoch: [1]" in capsys.readouterr().out
    _assert_tree_equal(_latest_payload(whole), _latest_payload(half))


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_cli_compilation_cache_flag_sets_the_cache_directory(tmp_path, capsys, monkeypatch, cli):
    """--compilation-cache DIR, on both CLIs as on the reference's
    (train.py:183,286, eval.py:36,45): the run goes through and Inductor's
    and Triton's caches point into DIR."""
    from mnasnet_tpu_torch import eval as eval_cli
    from mnasnet_tpu_torch.utils.compilation_cache import disable_compilation_cache

    for var in ("MNASNET_TPU_COMPILATION_CACHE", "TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    cache = tmp_path / "cache"
    out = tmp_path / "run"
    try:
        train_cli.main([*BASE, "--epochs", "1", "--output-dir", str(out),
                        *(["--compilation-cache", str(cache)] if cli == "train" else [])])
        if cli == "eval":
            eval_cli.main([str(_image_folder(tmp_path / "data")), "--arch", "mnasnet0_35",
                           "--image-size", "32", "--device", "cpu", "--workers", "0",
                           "--resume", str(out), "-b", "4", "--compilation-cache", str(cache)])
        assert " * Acc@1 " in capsys.readouterr().out
        assert cache.is_dir()
        assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(cache)
        assert os.environ["TRITON_CACHE_DIR"] == str(cache / "triton")
    finally:
        disable_compilation_cache()


def test_pretrained_model_ema_shadow_starts_from_the_init(tmp_path, monkeypatch):
    """As the reference (train.py:460,502-505): the train state, with the
    model-EMA shadow, is made before --pretrained replaces the weights, so
    the shadow at step 0 holds the init from --seed, not the loaded
    weights."""
    loaded = train_cli_model(seed=7)
    npz = tmp_path / "w.npz"
    np.savez(npz, **{k: v.numpy() for k, v in loaded.state_dict().items()})
    init = dict(train_cli_model(seed=0).named_parameters())
    seen = {}
    orig = Trainer.train_epoch

    def first_epoch(self, state, loader, epoch, **kw):
        from mnasnet_tpu_torch.train.optim import get_ema_params

        seen.update({n: t.clone() for n, t in get_ema_params(self.tx).items()})
        seen["weights"] = dict(self.model.named_parameters())["layers.0.weight"].detach().clone()
        self.request_stop()
        return orig(self, state, loader, epoch, **kw)

    monkeypatch.setattr(Trainer, "train_epoch", first_epoch)
    train_cli.main([*BASE, "--epochs", "1", "--pretrained", str(npz), "--model-ema", "0.5",
                    "--output-dir", str(tmp_path / "run")])
    assert torch.equal(seen.pop("weights"), loaded.state_dict()["layers.0.weight"])
    assert seen.keys() == init.keys()
    for n, p in init.items():
        assert torch.equal(seen[n], p.detach()), n
    assert not torch.equal(seen["layers.0.weight"], loaded.state_dict()["layers.0.weight"])


def train_cli_model(seed):
    from mnasnet_tpu_torch import create_model

    return create_model("mnasnet0_35", device="cpu", num_classes=8, seed=seed)


def test_cli_two_processes_on_the_cpu(tmp_path):
    """Two processes over gloo (--dist-url file://, --device cpu), 2 synthetic
    steps of a global batch of 16: rank 0 alone prints the meters and the
    epoch line, and one checkpoint is written, by rank 0."""
    out = tmp_path / "run"
    argv = [*_with(_with(BASE, "--batch-size", 16), "--synthetic-size", 32), "--epochs", "1",
            "--print-freq", "1", "--output-dir", str(out), "--world-size", "2",
            "--dist-url", f"file://{tmp_path / 'rendezvous'}"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-m", "mnasnet_tpu_torch.train", *argv,
                               "--rank", str(r)], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    text0, text1 = outs[0][0], outs[1][0]
    assert "Epoch: [0][0/2]" in text0 and "Epoch: [0][1/2]" in text0 and "epoch 0: acc1=" in text0
    assert "Epoch:" not in text1 and "epoch 0:" not in text1
    assert CheckpointManager(str(out)).keys() == [0]


def test_cli_flag_resolution():
    args = train_cli.parse_args(["--synthetic", "--deterministic"])
    assert args.seed == 0 and args.bn_stats == "two_pass" and args.device == "cuda"
    assert train_cli.parse_args(["--synthetic", "--deterministic", "--seed", "7"]).seed == 7
    assert train_cli.parse_args(["--synthetic", "--pretrained"]).pretrained == "__auto__"
    args = train_cli.parse_args(["--synthetic", "--no-scale-lr", "--world-size", "1",
                                 "--rank", "0"])
    assert args.scale_lr is False
    for spelling, route in (("pallas", "kernel"), ("xla", "torch"), ("kernel", "kernel")):
        assert train_cli.CLI_IMPLS[train_cli.parse_args(["--fused-kernels", spelling])
                                .fused_kernels] == route


def test_cli_profile_steps_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "run"
    train_cli.main([*BASE, "--epochs", "1", "--profile-steps", "1:2", "--output-dir", str(out)])
    assert {"trace.json", "kernels.txt"} <= set(os.listdir(out / "profile"))
    assert "Self CPU" in (out / "profile" / "kernels.txt").read_text()


def test_cli_deterministic_runs_bitwise_identical(tmp_path, capsys):
    dirs = [tmp_path / "a", tmp_path / "b"]
    for d in dirs:
        train_cli.main([*BASE, "--deterministic", "--epochs", "1", "--output-dir", str(d)])
    assert not torch.are_deterministic_algorithms_enabled()  # restored on exit
    _assert_same_weights(*dirs)


def test_deterministic_turns_cudnn_tf32_off_on_a_card(monkeypatch):
    """On a CUDA device ``--deterministic`` also turns cuDNN's TF32 off: with
    it on, cuDNN picks TF32 algorithms by shape, and the stem's weight
    gradient over two ranks' halves and over the whole batch differed by
    27.2% relative RMS on an H100 at random init, against 0.42% with it off
    (``tools/stem_grad_order.py``, PERF.md); ``main`` restores the flag."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    previous = torch.are_deterministic_algorithms_enabled()
    try:
        train_cli._set_deterministic(torch.device("cuda"))
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.benchmark is False
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(previous)
    torch.backends.cudnn.allow_tf32 = True
    train_cli._set_deterministic(torch.device("cpu"))  # the CPU has no TF32 to turn off
    torch.use_deterministic_algorithms(previous)
    assert torch.backends.cudnn.allow_tf32 is True


def test_cli_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([*argv, "--epochs", "1", "--output-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def _image_folder(root, classes=3, per_class=4, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train", per_class), ("val", per_class - 1)):
        for c in range(classes):
            d = root / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(n):
                base = rng.integers(0, 256, (6, 7, 3)).astype(np.uint8)
                Image.fromarray(base).resize((45, 40), Image.Resampling.BILINEAR).save(
                    d / f"{i}.jpg", quality=90)
    return root


def _eval(args):
    return subprocess.run([sys.executable, "-m", "mnasnet_tpu_torch.eval", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_eval_cli_data_dir_and_resume(tmp_path, capsys):
    """The trainer's score of a checkpoint is what the eval CLI prints for it
    (the same loader, decoder and padded tail), from best/ and with the EMA."""
    data = _image_folder(tmp_path / "data")
    out = tmp_path / "run"
    common = ["--arch", "mnasnet0_35", "--image-size", "32", "--dtype", "float32",
              "--device", "cpu", "--workers", "2"]
    train_cli.main([str(data), *common, "--num-classes", "3", "--batch-size", "4",
                    "--epochs", "1", "--seed", "0", "--model-ema", "0.5", "--bn-recalibrate",
                    "2", "--print-freq", "100", "--output-dir", str(out)])
    text = capsys.readouterr().out
    best = CheckpointManager(str(out)).best_epoch()
    assert best is not None
    line = [ln for ln in text.splitlines()
            if ln.startswith("epoch 0:" if best == 0 else "bn-recalibrated:")][0]
    acc1 = line.split("acc1=")[1].split(" ")[0]

    r = _eval([str(data), *common, "--resume", str(out), "--best", "--use-ema", "-b", "4"])
    assert r.returncode == 0, r.stderr
    assert f" * Acc@1 {acc1} " in r.stdout
    r = _eval([str(data / "val"), *common, "--resume", str(out), "-b", "4", "--decoder", "pil"])
    assert r.returncode == 0, r.stderr
    assert " * Acc@1 " in r.stdout
    r = _eval([str(data), *common, "--pretrained", "x.pth", "--use-ema"])
    assert r.returncode != 0 and "--use-ema requires --resume" in r.stderr
