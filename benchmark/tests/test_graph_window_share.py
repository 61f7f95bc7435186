"""``graph_window_share.synth`` on hand-made traces: the share of window
spans that hold a replay span, 1.0 with every window replayed, 0.0 with
none, and None without window spans."""

from __future__ import annotations

import pytest

import harness
from run import Context
from trace_reader import Trace

LAUNCH = "cudaLaunchKernel"


def _read(host):
    trace = Trace([("kernel", 0.0, 10.0)], host, (0.0, 10.0))
    return harness.metric_reader("graph_window_share.synth").read(
        Context(ops=trace, units=1))


def _windows(*bounds):
    return [("ha2g.synth.window", s, e) for s, e in bounds]


def test_every_window_replayed_reads_one():
    host = _windows((1.0, 2.0), (2.0, 3.0), (4.0, 5.0)) + [
        ("ha2g.synth.replay", 1.1, 1.5), ("ha2g.synth.replay", 2.2, 2.3),
        ("ha2g.synth.replay", 4.5, 4.9), ("cudaGraphLaunch", 1.2, 1.21)]
    assert _read(host) == 1.0


def test_no_window_replayed_reads_zero():
    host = _windows((1.0, 2.0), (2.0, 3.0)) + [
        ("ha2g.model.level", 1.1, 1.5), (LAUNCH, 1.2, 1.21)]
    assert _read(host) == 0.0


def test_some_windows_replayed():
    """The first window at a key runs op by op; a replay span outside
    every window counts for none."""
    host = _windows((1.0, 2.0), (2.0, 3.0), (3.0, 4.0), (5.0, 6.0)) + [
        ("ha2g.synth.replay", 2.1, 2.9), ("ha2g.synth.replay", 3.1, 3.9),
        ("ha2g.synth.replay", 4.2, 4.4)]
    assert _read(host) == pytest.approx(0.5)


def test_no_window_spans_read_none():
    host = [(LAUNCH, 1.0, 1.01), ("ha2g.synth.replay", 2.0, 3.0),
            ("bench_window", 0.0, 10.0)]
    assert _read(host) is None
