"""The timed path broken underneath a run: ``correct`` comes out false.
Faults: a train step that leaves its state unchanged; a train step on half
of its batch, the mean over the rest; a synthesis answer altered where it
is produced; the contrastive loss (B2), its gradient to the text side
(B3) or B1's backward altered where it is produced.  (B4's gradient to
the audio side is a ten-thousandth of the audio encoder's gradient at
HA2G's loss weights: no number of three steps sees it; PERF.md.)  (One chip: there is no exchange between
chips to leave out.)"""

from __future__ import annotations

import numpy as np
import pytest

from conftest import tiny_run


def test_sound_runs_are_correct():
    assert tiny_run("gesture-train-b256")["correct"]


def test_step_leaving_state_unchanged(monkeypatch):
    import ha2g_torch.train.hierarchy as h

    def no_step(opt, loss, mesh=None, clip=None, regather=False):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    monkeypatch.setattr(h, "optimizer_step", no_step)
    r = tiny_run("gesture-train-b256")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] > r["checks"]["change_gap"]["limit"]


def test_step_on_half_the_batch(monkeypatch):
    from ha2g_torch.train.hierarchy import HierarchySystem
    full = HierarchySystem._batch

    def half(self, batch):
        return tuple(t[: t.shape[0] // 2] for t in full(self, batch))
    monkeypatch.setattr(HierarchySystem, "_batch", half)
    assert not tiny_run("gesture-train-b256")["correct"]


def test_answer_altered(monkeypatch):
    from ha2g_torch.synthesis import HierarchySynthesizer
    run_fused = HierarchySynthesizer.run_fused

    def altered(self, *a, **kw):
        # every clip answered with its neighbour's poses
        return np.roll(run_fused(self, *a, **kw), 1, axis=0)
    monkeypatch.setattr(HierarchySynthesizer, "run_fused", altered)
    r = tiny_run("expressive-batch256")
    assert not r["correct"]


def test_contrastive_loss_altered(monkeypatch):
    import ha2g_torch.ops.contrastive as c
    right = c.contrastive_fwd

    def altered(*a):
        # B2's diagonal logits at 0.8 of their size
        logz, diag = right(*a)
        return logz, 0.8 * diag
    monkeypatch.setattr(c, "contrastive_fwd", altered)
    r = tiny_run("gesture-train-b256")
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


def test_contrastive_gradient_altered(monkeypatch):
    import ha2g_torch.ops.contrastive as c
    right = c.contrastive_bwd_da

    def altered(*a):
        # B3: the gradient to the text side at half its size
        return 0.5 * right(*a)
    monkeypatch.setattr(c, "contrastive_bwd_da", altered)
    r = tiny_run("gesture-train-b256")
    assert not r["correct"]
    assert r["checks"]["grad_gap_gen"]["value"] > r["checks"]["grad_gap_gen"]["limit"]


def test_b1_backward_altered(monkeypatch):
    import ha2g_torch.ops.gru_kernel as g
    right = g.gru_backward_loop

    def altered(*a):
        # the recurrence's cotangents at 0.9 of their size
        return tuple(0.9 * t if t is not None else t for t in right(*a))
    monkeypatch.setattr(g, "gru_backward_loop", altered)
    r = tiny_run("gesture-train-b256")
    assert not r["correct"]
