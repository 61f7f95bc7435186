"""The fused loop's ``chunk`` and ``out_dtype``, the FLOP counting of
``utils/roofline.py``, and the last pieces of the JAX API (``merge_clips``,
``remove_tags_marks``, ``Trainer.fit(eval_every, log_every)``) on the
CPU, against the JAX package.

The synthesis cases use the 3-level TED Gesture hierarchy at hidden 32 and
2 GRU layers with speaker z pinned at mu (as
tests/test_synthesis.py::test_fused_chunked_matches_unchunked sets it
up), its JAX state built from the port's seeded weights through the JAX
package's importers (no ``HierarchySystem.init``), 4 clips of 5 s.
"""

import logging
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu.data import storage as jax_storage
from ha2g_tpu.data.vocab import remove_tags_marks as jax_remove_tags_marks
from ha2g_tpu.synthesis import HierarchySynthesizer as JaxSynthesizer
from ha2g_tpu.train import loop as jax_loop
from ha2g_tpu.utils import roofline as jax_roofline
from tests.test_torch_bridge import (N_SPK, N_WORDS, clips, jax_hierarchy,
                                     jax_state_dict, port_config, vocabs)

from ha2g_torch.config import Config
from ha2g_torch.data import storage
from ha2g_torch.data.synthetic import synthetic_clips
from ha2g_torch.data.vocab import remove_tags_marks
from ha2g_torch.models.common import init_parameters_
from ha2g_torch.models.hierarchy import HierarchicalWavEncoder
from ha2g_torch.ops import contrastive as C
from ha2g_torch.ops import gru_kernel as G
from ha2g_torch.skeleton import TED_GESTURE
from ha2g_torch.synthesis import make_synthesizer
from ha2g_torch.train.hierarchy import HierarchySystem
from ha2g_torch.train.loop import Trainer
from ha2g_torch.utils.roofline import count_flops, mfu_line

HIDDEN = 32
# chunked against unchunked in the port: the bound of the devices test
# (tests/test_torch_parallel.py), the CPU's products summing in another
# order at another batch
CHUNK_ATOL = 2e-4
# the port against the JAX package, fp32 (tests/test_torch_synthesis.py)
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def synths():
    """(JAX synthesizer, port synthesizer, JAX lang, port lang) with the
    same weights, speaker z pinned at mu."""
    _, system, state = jax_hierarchy("ted_gesture", 27, hidden=HIDDEN)
    port = HierarchySystem(port_config("ted_gesture", 27, HIDDEN), N_WORDS,
                           N_SPK, device="cpu")
    (jlang, _), (lang, _) = vocabs()
    return (JaxSynthesizer(system, state),
            make_synthesizer(port, jax_state_dict(state)), jlang, lang)


@pytest.fixture(scope="module")
def batch():
    return clips(B=4, seconds=5.0, seed=2)


def _run(synth, lang, batch, **kw):
    audio, words, vids = batch
    plan = synth.prepare_fused(words, lang, vids, audio.shape[1],
                               torch.Generator().manual_seed(7))
    return synth.run_fused(audio, plan, **kw)


@pytest.fixture(scope="module")
def pulls(synths, batch):
    """The port's float32 pulls by chunk (0: one part; 3: a ragged last
    chunk of one clip)."""
    _, synth, _, lang = synths
    return {chunk: _run(synth, lang, batch, chunk=chunk)
            for chunk in (0, 2, 3)}


def test_chunked_run_fused_matches_unchunked_and_jax(synths, batch, pulls):
    jsynth, _, jlang, _ = synths
    one = pulls[0]
    assert one.dtype == np.float32 and one.shape[0] == 4
    for chunk in (2, 3):
        got = pulls[chunk]
        assert got.dtype == np.float32 and got.shape == one.shape
        np.testing.assert_allclose(got, one, atol=CHUNK_ATOL, rtol=0)
    audio, words, vids = batch
    plan = jsynth.prepare_fused(words, jlang, vids, audio.shape[1],
                                rng=jax.random.PRNGKey(7))
    want = jsynth.run_fused(audio, plan, chunk=2)
    np.testing.assert_allclose(pulls[2], want, atol=JAX_ATOL, rtol=0)


def test_float16_pull(synths, batch, pulls):
    """float32 out, the float32 pull rounded to float16 exactly, within
    2e-3 max|x| of it (JAX's test).  JAX's chunked float16 pull equals its
    unchunked one bit for bit; the port's chunks run the CPU's products at
    another batch, whose sums differ in the last bits (4e-7 here), so the
    two float16 pulls are each their own float32 pull rounded, and within
    one float16 step of each other."""
    _, synth, _, lang = synths
    one, chunked = pulls[0], pulls[2]
    f16 = _run(synth, lang, batch, out_dtype=np.float16)
    f16c = _run(synth, lang, batch, chunk=2, out_dtype=np.float16)
    assert f16.dtype == f16c.dtype == np.float32
    np.testing.assert_allclose(f16, one, atol=2e-3 * np.abs(one).max(),
                               rtol=0)
    np.testing.assert_array_equal(f16, one.astype(np.float16))
    np.testing.assert_array_equal(f16c, chunked.astype(np.float16))
    # one float16 step: 2^-10 of the value's binade, 2^-24 below 2^-14
    np.testing.assert_allclose(f16c, f16, rtol=2.0 ** -10, atol=2.0 ** -24)
    with pytest.raises(ValueError):
        _run(synth, lang, batch, out_dtype=np.int8)


def test_chunks_over_devices_match_one_call(batch):
    """``chunk`` with ``devices``: each chunk splits over the devices and
    draws its batch's speaker-z noise (z on) as one device does; the
    generator ends where the single-device call leaves it.  A chunk that
    does not divide by the devices raises."""
    system = HierarchySystem(port_config("ted_gesture", 27, HIDDEN),
                             N_WORDS, N_SPK, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    synth = make_synthesizer(system, system.state_dict())
    _, (lang, _) = vocabs()
    audio, words, vids = batch
    outs, after = [], []
    for devices in (None, ["cpu", "cpu"]):
        gen = torch.Generator().manual_seed(1)
        plan = synth.prepare_fused(words, lang, vids, audio.shape[1], gen)
        outs.append(synth.run_fused(audio, plan, chunk=2, devices=devices))
        after.append(torch.rand(3, generator=gen))
    np.testing.assert_allclose(outs[1], outs[0], atol=CHUNK_ATOL, rtol=0)
    assert torch.equal(after[0], after[1])
    for chunk in (1, 3):     # chunks of 1, and a last chunk of 1
        with pytest.raises(ValueError):
            _run(synth, lang, batch, chunk=chunk, devices=["cpu"] * 2)


def test_count_flops_se_resnet_against_xla():
    """The full-width 6-level SE-ResNet at (2, 128, 70): torch counts every
    tap of a padded convolution, XLA leaves the zero taps out (measured
    ratio 1.0456)."""
    from ha2g_tpu import import_torch as it
    from ha2g_tpu.models.hierarchy import HierarchicalWavEncoder as JaxEnc

    enc = HierarchicalWavEncoder(pose_level=6, n_speakers=N_SPK)
    init_parameters_(enc, torch.Generator().manual_seed(0))
    enc.eval()
    rng = np.random.default_rng(0)
    spec = rng.normal(size=(2, 128, 70)).astype(np.float32)
    vids = np.array([1, 3])
    with torch.inference_mode():
        ours = count_flops(enc, torch.from_numpy(spec),
                           torch.from_numpy(vids))
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    params, stats = it.convert_audio_encoder(sd)
    jenc = JaxEnc(pose_level=6, n_speakers=N_SPK)
    fn = jax.jit(lambda s, v: jenc.apply(
        {"params": params, "batch_stats": stats}, s, v, train=False))
    xla = jax_roofline.compiled_flops(fn, jnp.asarray(spec),
                                      jnp.asarray(vids))
    assert xla is not None and ours is not None
    assert 1.00 <= ours / xla <= 1.06, (ours, xla)


def test_count_flops_kernels_by_formula():
    """Each hand kernel counts its formula on the CPU route, and its plain
    version's products are not added on top."""
    from torch.utils.flop_counter import FlopCounterMode
    T, B, H, N, D = 6, 3, 8, 20, 8
    g = torch.Generator().manual_seed(0)
    xp = torch.randn((T, 2, B, 3 * H), generator=g)
    h0 = torch.randn((2, B, H), generator=g)
    w_hh = torch.randn((2, H, 3 * H), generator=g) * 0.3
    b_hh = torch.randn((2, 3 * H), generator=g)
    D2, G3 = 2, 3 * H
    assert count_flops(G.gru_recurrence, xp, h0, w_hh, b_hh) == \
        2 * T * D2 * B * H * G3 + 10 * T * D2 * B * H
    outs = G.gru_recurrence(xp, h0, w_hh, b_hh)
    h_prev = torch.cat([h0[None], outs[:-1]])
    hh = torch.einsum("tdbh,dhg->tdbg", h_prev, w_hh) + b_hh[None, :, None]
    d_outs = torch.randn(outs.shape, generator=g)
    loop_args = (xp, hh, h_prev, w_hh, d_outs)
    a = torch.nn.functional.normalize(torch.randn((N, D), generator=g), dim=1)
    b = torch.nn.functional.normalize(torch.randn((N, D), generator=g), dim=1)
    logz, _ = C.contrastive_fwd_plain(a, b)
    gn = torch.tensor([0.05])
    cases = [(G.gru_backward_loop, G.gru_backward_loop_plain, loop_args,
              loop_args, G.backward_loop_flops(T, B, H)),
             (C.contrastive_fwd, C.contrastive_fwd_plain, (a, b), (a, b),
              C.fwd_flops(N, D)),
             (C.contrastive_bwd_da, C.contrastive_bwd_da_plain,
              (a, b, logz, gn), (a, b, logz, gn.reshape(())),
              C.bwd_flops(N, D)),
             (C.contrastive_bwd_db, C.contrastive_bwd_db_plain,
              (a, b, logz, gn), (a, b, logz, gn.reshape(())),
              C.bwd_flops(N, D))]
    for wrapper, plain, args, plain_args, want in cases:
        with FlopCounterMode(display=False) as mode:
            plain(*plain_args)
        # the formula is the mode's count of the plain version
        assert mode.get_total_flops() == want, wrapper.__name__
        assert count_flops(wrapper, *args) == want, wrapper.__name__
    # through autograd: B1 forward, then the backward's two hoisted
    # products (counted by the mode on both routes) around the loop
    leaves = [t.clone().requires_grad_() for t in (xp, h0, w_hh, b_hh)]
    hoisted = 2 * T * D2 * B * H * G3
    assert count_flops(lambda: G.gru_recurrence_fn(*leaves).sum().backward()
                       ) == (G.forward_flops(T, B, H)
                             + G.backward_loop_flops(T, B, H) + 2 * hoisted)
    assert count_flops(lambda: None) is None


def test_mfu_line_states_why():
    """Without a peak entry the line says so, in the JAX package's words
    (its CPU device kind is "cpu" too); with one it gives the share."""
    line = mfu_line(2e12, 0.5, "cpu")
    assert line == "4.00 TFLOP/s (2000.0 GFLOP/call; no peak table entry " \
        "for 'cpu')"
    assert line == jax_roofline.mfu_line(2e12, 0.5)
    assert mfu_line(None, 1.0, "cpu").startswith("flops unavailable")


def test_merge_clips_round_trip(tmp_path):
    """tests/test_data.py::test_merge_clips on the port's storage; the
    merged store reads the same in the JAX package."""
    a = synthetic_clips(TED_GESTURE, n_clips=2, clip_seconds=4.0, seed=1)
    b = synthetic_clips(TED_GESTURE, n_clips=3, clip_seconds=4.0, seed=2)
    storage.save_clips(tmp_path / "a", a)
    storage.save_clips(tmp_path / "b", b)
    n = storage.merge_clips([tmp_path / "a", tmp_path / "b"],
                            tmp_path / "merged")
    assert n == 5
    merged = storage.load_clips(tmp_path / "merged")
    assert len(merged) == 5
    np.testing.assert_array_equal(merged[0]["skeletons_3d"],
                                  np.asarray(a[0]["skeletons_3d"],
                                             np.float32))
    np.testing.assert_array_equal(merged[2]["skeletons_3d"],
                                  np.asarray(b[0]["skeletons_3d"],
                                             np.float32))
    jax_storage.merge_clips([tmp_path / "a", tmp_path / "b"],
                            tmp_path / "jax")
    theirs = jax_storage.load_clips(tmp_path / "jax")
    for x, y in zip(merged, theirs):
        assert x["vid"] == y["vid"] and x["words"] == y["words"]
        np.testing.assert_array_equal(x["audio_raw"], y["audio_raw"])


@pytest.mark.parametrize("text", [
    "Hello, world!", "<i>so</i> what?!", "a.b,c:d;e!f?g", "no marks here",
    "<b>tag</b> <unclosed ... wait;", "", "dots... and ?!?! runs"])
def test_remove_tags_marks_matches_jax(text):
    assert remove_tags_marks(text) == jax_remove_tags_marks(text)


# ---------------------------------------------------------------------------
# Trainer.fit(eval_every, log_every): the schedule against the JAX trainer's
# ---------------------------------------------------------------------------

CONFIG = (Path(__file__).resolve().parent.parent / "configs"
          / "gesture_autoencoder.yaml")
# the validation loss of each evaluation, by epoch (3: the closing one)
VAL_LOSS = {0: 2.0, 1: 0.1, 2: 1.0, 3: 1.5}


@pytest.fixture(scope="module")
def trainer_data():
    from ha2g_torch.data.dataset import window_clips
    from ha2g_torch.data.vocab import Vocab, build_vocab
    clip_set = synthetic_clips(TED_GESTURE, n_clips=2, clip_seconds=5.0,
                               seed=3)
    lang = build_vocab("words", [clip_set])
    speaker = Vocab("vid", insert_default_tokens=False)
    for c in clip_set:
        speaker.index_word(c["vid"])
    cfg = Config.from_yaml(CONFIG)
    samples = window_clips(clip_set, TED_GESTURE, lang, speaker,
                           cfg.mean_pose_array, cfg.mean_dir_vec_array)
    return samples, lang, speaker


def _port_schedule(tmp_path, trainer_data, **fit_kw):
    """The port's Trainer.fit with evaluations stubbed to VAL_LOSS and
    checkpoint writes recorded -> (history, saves, trainer)."""
    samples, lang, speaker = trainer_data
    cfg = Config.from_yaml(CONFIG, batch_size=2, epochs=3, random_seed=0,
                           model_save_path=str(tmp_path / "out"))
    trainer = Trainer(cfg, samples, samples, lang, speaker, device="cpu")
    saves = []
    trainer.validate = lambda epoch: {"loss": VAL_LOSS[epoch]}
    trainer.save = lambda path, extra: saves.append((Path(path).name,
                                                     extra["epoch"]))
    history = trainer.fit(**fit_kw)
    return history, saves, trainer


def _jax_schedule(monkeypatch, tmp_path, n_batches, **fit_kw):
    """The JAX Trainer.fit's schedule on the same stubs: no system, a step
    that returns a constant loss -> (history, saves)."""
    from ha2g_tpu.config import Config as JaxConfig
    trainer = object.__new__(jax_loop.Trainer)
    trainer.cfg = JaxConfig(model="hierarchy", epochs=3)
    trainer.lang = trainer.speaker = None
    trainer.tb, trainer.profile_dir = None, None
    trainer.best_values = {}
    trainer.rng = jax.random.PRNGKey(0)
    trainer.train_loader = [{}] * n_batches
    trainer.init_state = lambda: None
    trainer.evaluate = lambda state, epoch: {"loss": VAL_LOSS[epoch]}
    trainer._train_step = lambda epoch: (
        lambda state, batch, rng: (state, {"loss": np.float32(1.0)}))
    saves = []
    monkeypatch.setattr(jax_loop, "save_checkpoint",
                        lambda path, *a, extra: saves.append(
                            (Path(path).name, extra["epoch"])))
    _, history = trainer.fit(save_path=str(tmp_path / "jax"), **fit_kw)
    return history, saves


def test_fit_eval_every_follows_jax(tmp_path, trainer_data, monkeypatch):
    """eval_every=2 over 3 epochs: evaluations at epochs 0 and 2 and the
    closing one, the best checkpoint at 0 (loss 2.0) then 2 (1.0): epoch
    1's 0.1 is never evaluated."""
    history, saves, trainer = _port_schedule(tmp_path, trainer_data,
                                             eval_every=2)
    jhistory, jsaves = _jax_schedule(monkeypatch, tmp_path,
                                     len(trainer.train_loader), eval_every=2)
    assert [r["epoch"] for r in history] == [0, 2, 3]
    assert history == jhistory
    assert saves == jsaves == [("checkpoint_best", 0),
                               ("checkpoint_best", 2),
                               ("checkpoint_final", 2)]
    rows = (tmp_path / "out" / "history.jsonl").read_text().splitlines()
    assert len(rows) == 3
    # the default evaluates every epoch, as before
    history, saves, _ = _port_schedule(tmp_path / "every", trainer_data)
    assert [r["epoch"] for r in history] == [0, 1, 2, 3]
    assert saves[:2] == [("checkpoint_best", 0), ("checkpoint_best", 1)]


def test_fit_log_every_logs_every_n_iterations(tmp_path, trainer_data,
                                               monkeypatch, caplog):
    """log_every=3: a line every 3 global iterations across epochs, with
    the running means and samples/s, at the JAX trainer's iterations."""
    pattern = re.compile(r"^ep (\d+) it (\d+): (.*), ([\d.]+) samples/s$")

    def lines():
        found = [pattern.match(r.getMessage()) for r in caplog.records]
        return [(int(m[1]), int(m[2])) for m in found if m]

    with caplog.at_level(logging.INFO):
        _, _, trainer = _port_schedule(tmp_path, trainer_data, log_every=3)
        ours = lines()
        caplog.clear()
        steps = len(trainer.train_loader)
        _jax_schedule(monkeypatch, tmp_path, steps, log_every=3)
        theirs = lines()
    assert steps >= 3
    want = [(it_ - 1) // steps for it_ in range(3, 3 * steps + 1, 3)]
    assert [e for e, _ in ours] == want
    assert ours == theirs
    assert [i for _, i in ours] == list(range(3, 3 * steps + 1, 3))
