"""The port's host spans (``utils/profiling.py:span``) in the routed calls,
the train step and the trainer's loop, on the CPU: what a profiler records,
how the spans nest, that their counts agree with the routes' counters, and
that nothing is recorded or built when no profiler runs.

The graph route's spans are held on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_train_step
from mnasnet_tpu_torch.train.trainer import Trainer
from mnasnet_tpu_torch.utils import profiling
from mnasnet_tpu_torch.utils.profiling import span
from mnasnet_tpu_torch.utils.routing import BatchRouted


def _spans(prof) -> list[tuple[str, int, int]]:
    """The port's host spans, (name, start, end) in ns, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.name().startswith("mnasnet.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _count(spans, name: str) -> int:
    return sum(n == name for n, _, _ in spans)


def _inside(spans, child: str, parent: str) -> bool:
    """Every ``child`` span lies within some ``parent`` span."""
    outer = [(a, b) for n, a, b in spans if n == parent]
    return all(any(a <= s and e <= b for a, b in outer) for n, s, e in spans if n == child)


def _children(spans, parent: str) -> list[list[str]]:
    """The names of the spans inside each ``parent`` span, in start order,
    one list per parent (nested children included)."""
    return [[n for n, s, e in spans if n != parent and a <= s and e <= b]
            for name, a, b in spans if name == parent]


def test_span_without_a_profiler_is_the_shared_no_op_and_builds_no_args():
    def args():
        raise AssertionError("args built with no profiler running")

    a, b = span("mnasnet.x", args), span("mnasnet.y")
    assert a is b is profiling._OFF
    with a, b, a:  # stateless: nested and reused
        pass


def test_span_under_a_profiler_records_its_name_and_builds_its_args_once():
    built = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = span("mnasnet.x", lambda: built.append(1) or "route=eager")
        assert isinstance(s, torch.profiler.record_function) and s.args == "route=eager"
        with s:
            with span("mnasnet.y"):
                pass
    assert built == [1]
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == ["mnasnet.x", "mnasnet.y"]
    assert _inside(spans, "mnasnet.y", "mnasnet.x")
    assert span("mnasnet.z") is profiling._OFF  # off again once the profiler stops


def test_eager_batch_routed_call_spans_and_counts():
    """Three calls, two input shapes: each call holds its copy-in, a key's
    first call its build, then its run; the counts are the counters'."""
    routed = BatchRouted(lambda x: x + 1, route_for=lambda bs: "eager")
    xs = [np.zeros((2, 3), np.float32), torch.zeros(2, 3), torch.zeros(5, 3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for x in xs:
            routed(x)
    spans = _spans(prof)
    assert _children(spans, "mnasnet.route.call") == [
        ["mnasnet.route.copy_in", "mnasnet.route.build", "mnasnet.route.run"],
        ["mnasnet.route.copy_in", "mnasnet.route.run"],
        ["mnasnet.route.copy_in", "mnasnet.route.build", "mnasnet.route.run"]]
    assert _count(spans, "mnasnet.route.call") == sum(routed.calls.values()) == 3
    assert _count(spans, "mnasnet.route.build") == len(routed.calls) == 2
    assert _count(spans, "mnasnet.route.replay") == _count(spans, "mnasnet.route.copy_out") == 0
    for child in ("copy_in", "build", "run"):
        assert _inside(spans, f"mnasnet.route.{child}", "mnasnet.route.call")


def _train_setup():
    model = create_model("mnasnet0_35", device="cpu", num_classes=8, bn_ema="external",
                         stem_s2d=True, seed=0)
    tx = create_optimizer("rmsprop", 1e-3, fused="small")
    return model, tx


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 8, n).astype(np.int32))


def test_eager_train_step_spans_and_counts():
    """Three eager steps: each holds its copy-in and host part, the first
    its build, the others their run; no copy-out on the eager route."""
    model, tx = _train_setup()
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx, 0.1, route="eager")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            state, _ = step(state, *_batch(i))
    spans = _spans(prof)
    first = ["mnasnet.train.copy_in", "mnasnet.train.host", "mnasnet.train.build"]
    later = ["mnasnet.train.copy_in", "mnasnet.train.host", "mnasnet.train.run"]
    assert _children(spans, "mnasnet.train.step") == [first, later, later]
    assert _count(spans, "mnasnet.train.step") == sum(step.calls.values()) == 3
    assert _count(spans, "mnasnet.train.build") == len(step.calls) == 1
    assert _count(spans, "mnasnet.train.replay") == _count(spans, "mnasnet.train.copy_out") == 0
    assert state.step == 3


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler running the routed calls and the step make no
    ``record_function`` and build no span arguments."""
    def refused(*args, **kwargs):
        raise AssertionError("record_function made with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    routed = BatchRouted(lambda x: x + 1, route_for=lambda bs: "eager")
    routed(torch.zeros(2, 3))
    routed(torch.zeros(2, 3))
    model, tx = _train_setup()
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx, 0.1, route="eager")
    for i in range(2):
        state, _ = step(state, *_batch(i))
    assert sum(routed.calls.values()) == sum(step.calls.values()) == 2


class _Loader:
    """Three steps of 4 random 32 px images."""

    def steps_per_epoch(self):
        return 3

    def epoch(self, epoch, start_step=0):
        for i in range(start_step, 3):
            yield _batch(i)


def test_trainer_loop_spans_the_loader_wait_and_the_late_metrics_read():
    """An epoch of three steps: a data span before each step (and one for
    the loader's end), a metrics read after the second and third steps and
    one after the loop; each step's own spans beside them."""
    model, tx = _train_setup()
    trainer = Trainer(model, tx, device="cpu", print_freq=100)
    state = trainer.create_state(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(state, _Loader(), 0)
    spans = _spans(prof)
    top = [n for i, (n, s, e) in enumerate(spans)
           if not any(a <= s and e <= b for j, (_, a, b) in enumerate(spans) if j != i)]
    assert top == ["mnasnet.train.data", "mnasnet.train.step",
                   "mnasnet.train.data", "mnasnet.train.step", "mnasnet.train.metrics",
                   "mnasnet.train.data", "mnasnet.train.step", "mnasnet.train.metrics",
                   "mnasnet.train.data", "mnasnet.train.metrics"]
    assert _count(spans, "mnasnet.train.step") == sum(trainer._train_step.calls.values()) == 3


def test_spans_start_inside_a_profiled_window_only():
    """A profiler started between calls sees the calls after it whole and
    none before it: the switch is read at each span."""
    routed = BatchRouted(lambda x: x * 2, route_for=lambda bs: "eager")
    routed(torch.ones(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        routed(torch.ones(3))
    routed(torch.ones(3))
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == ["mnasnet.route.call", "mnasnet.route.copy_in",
                                        "mnasnet.route.run"]
    assert sum(routed.calls.values()) == 3
