"""The readers of the program's spans on hand-made traces: launch calls
outside the spans are not counted, a call inside nested spans counts
once, a trace without the spans reads None, and the loader's mean leaves
out the epoch's closing wait."""

from __future__ import annotations

import pytest

import harness
from run import Context
from trace_reader import Trace

LAUNCH = "cudaLaunchKernel"


def _read(metric, host, units=1):
    trace = Trace([("kernel", 0.0, 10.0)], host, (0.0, 10.0))
    return harness.metric_reader(metric).read(Context(ops=trace, units=units))


def _steps(*bounds):
    return [(f"train_step#{i}", s, e) for i, (s, e) in enumerate(bounds)]


def test_launches_per_step_counts_inside_steps_only():
    host = _steps((1.0, 2.0), (3.0, 4.0)) + [
        ("ha2g.train.g_update", 1.5, 1.9),              # nested in step 0
        (LAUNCH, 1.1, 1.11), (LAUNCH, 1.6, 1.61),       # step 0, one nested
        ("cudaGraphLaunch", 3.5, 3.51),                  # step 1
        (LAUNCH, 0.5, 0.51), (LAUNCH, 2.5, 2.51),       # between steps
        ("aten::add", 3.2, 3.3)]                         # not a launch
    assert _read("launches_per_step.train", host) == 1.5


def test_window_launches_count_nested_windows_once():
    host = [("ha2g.synth.window", 1.0, 3.0), ("ha2g.synth.window", 1.5, 2.0),
            ("ha2g.model.gru_layer", 1.6, 1.9),
            (LAUNCH, 1.7, 1.71), (LAUNCH, 2.5, 2.51), (LAUNCH, 3.0, 3.01),
            ("ha2g.synth.window", 5.0, 6.0), (LAUNCH, 5.5, 5.51),
            (LAUNCH, 4.0, 4.01), (LAUNCH, 0.2, 0.21)]    # mel and pull
    assert _read("window_launches_per_call.synth", host, units=2) == 2.0


@pytest.mark.parametrize("metric", ["launches_per_step.train",
                                    "window_launches_per_call.synth",
                                    "loader_wait_span_ms.train"])
def test_no_span_reads_none(metric):
    host = [(LAUNCH, 1.0, 1.01), ("aten::mm", 2.0, 3.0),
            ("bench_window", 0.0, 10.0)]
    assert _read(metric, host) is None


def test_loader_mean_of_the_steps_waits():
    host = _steps((1.0, 2.0), (2.5, 3.0), (4.0, 5.0)) + [
        ("ha2g.trainer.loader_wait", 0.9, 0.9015),
        ("ha2g.trainer.loader_wait", 2.0, 2.5),
        ("ha2g.trainer.loader_wait", 3.0, 3.0025),
        ("ha2g.trainer.loader_wait", 5.0, 5.0001)]       # the closing next()
    assert _read("loader_wait_span_ms.train", host) == \
        pytest.approx(1e3 * (0.0015 + 0.5 + 0.0025) / 3)
