"""The ops modules' one launch path, ``kernels.launch``, and their routing,
``kernels.on_card``, on the CPU: a fake library function stands in for a
kernel, and ``torch.cuda.device`` and the current stream are patched, so
the launch's error, count and capture tally run without a card."""

import contextlib
import types

import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch import kernels

STREAM = 0xC0FFEE


def wrapper():
    """A kernel wrapper: what ``launch`` names and counts."""


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda.device and current_stream patched; -> the devices
    entered."""
    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=STREAM))
    monkeypatch.setattr(wrapper, "launches", 0, raising=False)
    return entered


@pytest.mark.parametrize("case", ["error", "counted", "captured"])
def test_launch(fake_card, case):
    """``fn(*args, stream)`` under the device: a nonzero return raises with
    the wrapper's name and the CUDA error and counts nothing; zero adds one
    to ``.launches``, or, inside ``captured_launches``, to the capture's
    tally and not to ``.launches``."""
    calls = []

    def fn(*args):
        calls.append(args)
        return 700 if case == "error" else 0

    device = torch.device("cuda", 0)
    tally = None
    if case == "error":
        with pytest.raises(RuntimeError,
                           match="^wrapper kernel launch failed: CUDA error "
                                 "700$"):
            kernels.launch(wrapper, fn, device, 1, 2.5)
    elif case == "counted":
        kernels.launch(wrapper, fn, device, 1, 2.5)
    else:
        with kernels.captured_launches() as tally:
            kernels.launch(wrapper, fn, device, 1, 2.5)
    assert calls == [(1, 2.5, STREAM)]
    assert fake_card == [device]
    assert wrapper.launches == (case == "counted")
    if case == "captured":
        assert tally == {wrapper: 1}
        kernels.add_launches(tally)     # a replay
        assert wrapper.launches == 1


def _on(device, contiguous=True):
    """A tensor's stand-in on ``device`` (a CUDA device needs no card)."""
    return types.SimpleNamespace(device=torch.device(device),
                                 is_contiguous=lambda: contiguous)


@pytest.mark.parametrize("case,tensors,want", [
    ("cpu", (torch.zeros(2), torch.zeros(3, 4).t()), False),
    ("card", (_on("cuda:0"), _on("cuda:0")), True),
    ("mixed", (torch.zeros(2), _on("cuda:0")), "one CUDA device"),
    ("two_cards", (_on("cuda:0"), _on("cuda:1")), "one CUDA device"),
    ("meta", (torch.zeros(2, device="meta"),), "one CUDA device"),
    ("non_contiguous", (_on("cuda:0"), _on("cuda:0", False)), "contiguous"),
])
def test_on_card(case, tensors, want):
    """All-CPU tensors (contiguous or not) take the plain version;
    contiguous tensors on one CUDA device the kernel; anything else
    raises."""
    if isinstance(want, bool):
        assert kernels.on_card(case, tensors) is want
    else:
        with pytest.raises(ValueError, match=f"^{case} needs .*{want}"):
            kernels.on_card(case, tensors)
