"""A traced window from torch.profiler, reduced to what the per-layer
metrics read: device intervals (kernels, copies, sets), host operations,
the launch calls the host made, and the window itself.

Two kinds of trace.  With CUDA activity alone (``record(fn)``) the
profiler records the device's work and the runtime's calls but no host
operation, so the host runs at nearly its untraced pace: the idle share
and the kernels' device times come from it.  Its window is the host's
clock around the work (the work, then a synchronise), and every device
record in it is the window's, since the device is idle before and after.
With CPU activity too (``record(fn, host_ops=True)``) every host
operation is recorded, which slows the host; only what does not depend
on the host's pace is read from it: the launch calls and the breakdown.
Its window is one ``record_function`` range around the work.

Either window is padded with ``PAD_S`` of host time before and after: on
an H100 the tracer drops the records of kernels launched in a window's
first milliseconds.
"""

from __future__ import annotations

import bisect
import time

PAD_S = 0.05
WINDOW = "bench_window"
# host calls that start work on the device: one a kernel or graph launch
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaLaunchCooperativeKernel")


def union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """Times in seconds from an arbitrary origin.  ``window`` is its (start,
    end) on the trace's clock, or None where ``window_s`` was taken on the
    host's clock and the records hold nothing else."""

    def __init__(self, device, host, window, window_s=None):
        self.window = window
        if window is None:
            self.device, self.host, self._window_s = device, host, window_s
            return
        a, b = window
        self.device = [(n, max(s, a), min(e, b)) for n, s, e in device
                       if e > a and s < b]
        self.host = [(n, s, e) for n, s, e in host if e > a and s < b]
        self._window_s = b - a

    @property
    def window_s(self) -> float:
        return self._window_s

    def busy_s(self) -> float:
        return sum(b - a for a, b in union([(s, e) for _, s, e in self.device]))

    def kernels(self, patterns) -> tuple[float, int]:
        """Device seconds and count of the kernels whose name holds one of
        ``patterns``."""
        hits = [e - s for n, s, e in self.device
                if any(p in n for p in patterns)]
        return sum(hits), len(hits)

    def launch_calls(self) -> dict:
        """Host calls that launched work on the device, by API name."""
        by = {}
        for n, _, _ in self.host:
            if n in LAUNCH_CALLS:
                by[n] = by.get(n, 0) + 1
        return by

    def top_device_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device seconds by what the host was doing: each gap between
        device intervals goes to the innermost host operation (not a launch
        call) running at its midpoint."""
        busy = union([(s, e) for _, s, e in self.device])
        edges = [self.window[0]] + [x for ab in busy for x in ab] \
            + [self.window[1]]
        ops = sorted((s, e, name) for name, s, e in self.host
                     if name not in LAUNCH_CALLS and name != WINDOW
                     and not name.startswith("cuda"))
        starts = [s for s, _, _ in ops]
        by = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = "no host op (Python between ops)"
            i0 = bisect.bisect_right(starts, mid) - 1
            # the latest-starting op still running at mid: the innermost
            for i in range(i0, max(i0 - 200, -1), -1):
                if ops[i][1] >= mid:
                    label = ops[i][2]
                    break
            by[label] = by.get(label, 0.0) + (b - a)
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def record(fn, host_ops: bool = False):
    """Run ``fn()`` once under torch.profiler, with CUDA activity and with
    ``host_ops`` CPU activity too, and return (its result, the Trace of
    its window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        with record_function(WINDOW):
            result = fn()
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        time.sleep(PAD_S)
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e9
        span = (e.name(), s, s + e.duration_ns() / 1e9)
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(span)
        elif e.name() == WINDOW and window is None:
            window = span[1:]
        else:
            host.append(span)
    if not host_ops:
        return result, Trace(device, host, None, window_s)
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    return result, Trace(device, host, window)
