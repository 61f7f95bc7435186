"""The program's spans (``ha2g_torch/utils/spans.py``) on the CPU: nothing
is entered without a profiler; under ``torch.profiler`` a tiny TED
Expressive ``run_fused`` call records exactly the synthesis and model
names, with a GRU layer span per window, level and layer nested in its
level inside its window; a tiny GAN epoch of ``Trainer.train_epoch``
records a ``train_step#<i>`` range a step holding the train step's spans,
and a loader-wait span around each ``next()`` on the loader."""

from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch.config import Config
from ha2g_torch.data.dataset import window_clips
from ha2g_torch.data.synthetic import synthetic_clips
from ha2g_torch.data.vocab import Vocab, build_vocab
from ha2g_torch.skeleton import TED_GESTURE
from ha2g_torch.synthesis import make_synthesizer
from ha2g_torch.train.hierarchy import HierarchySystem
from ha2g_torch.train.loop import Trainer
from ha2g_torch.utils import spans

ROOT = Path(__file__).resolve().parent.parent
N_WORDS, N_SPK, LAYERS = 16, 4, 2

SYNTH_NAMES = {"ha2g.synth.plan", "ha2g.synth.mel", "ha2g.synth.window",
               "ha2g.synth.pull", "ha2g.model.audio_encoder",
               "ha2g.model.se_block", "ha2g.model.level",
               "ha2g.model.text_encoder", "ha2g.model.gru_layer"}
TRAIN_NAMES = {"ha2g.train.audio", "ha2g.train.d_phase",
               "ha2g.train.g_forward", "ha2g.train.contrastive",
               "ha2g.train.diversity", "ha2g.train.g_update"}


def _ranges(prof):
    """(name, start, end) of every range the profiler kept, in order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    return sorted(out, key=lambda r: r[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_enters_nothing(monkeypatch):
    def entered(*args, **kw):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(spans.profiler, "record_function", entered)
    with spans.span("ha2g.synth.window", 3):
        with spans.span("ha2g.model.gru_layer"):
            pass
    assert spans.span("a") is spans.span("b")


def test_run_fused_spans():
    cfg = Config(model="hierarchy", dataset="ted_expressive", pose_dim=126,
                 n_poses=34, n_pre_poses=4, hidden_size=16, n_layers=LAYERS,
                 wordembed_dim=16, z_type="speaker")
    system = HierarchySystem(cfg, N_WORDS, N_SPK, device="cpu")
    synth = make_synthesizer(system, system.state_dict())
    lang = Vocab("words")
    for i in range(N_WORDS - lang.n_words):
        lang.index_word(f"w{i}")
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.normal(size=(2, 5 * 16000))).astype(np.float32)
    words = [[("w1", 0.5, 0.8), ("w2", 3.0, 3.2)], [("w3", 1.0, 1.4)]]
    vids = np.array([0, 3])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan = synth.prepare_fused(words, lang, vids, audio.shape[1])
        out = synth.run_fused(audio, plan)
    W, L = plan["num_sub"], cfg.skeleton.n_levels
    assert out.shape[0] == 2 and W >= 2 and L == 6
    ranges = [r for r in _ranges(prof) if r[0].startswith("ha2g.")]
    assert {r[0] for r in ranges} == SYNTH_NAMES
    count = lambda n: sum(r[0] == n for r in ranges)  # noqa: E731
    assert count("ha2g.synth.window") == W
    assert count("ha2g.model.level") == count("ha2g.model.text_encoder") \
        == W * L
    assert count("ha2g.model.gru_layer") == W * L * LAYERS
    assert count("ha2g.model.se_block") == 16      # 3 + 4 + 6 + 3 blocks
    windows = [r for r in ranges if r[0] == "ha2g.synth.window"]
    levels = [r for r in ranges if r[0] == "ha2g.model.level"]
    for g in (r for r in ranges if r[0] == "ha2g.model.gru_layer"):
        level = [lv for lv in levels if _inside(g, lv)]
        assert len(level) == 1
        assert any(_inside(level[0], w) for w in windows)


@pytest.fixture(scope="module")
def trainer():
    clips = synthetic_clips(TED_GESTURE, n_clips=2, clip_seconds=4.0, seed=5)
    lang = build_vocab("words", [clips])
    speaker = Vocab("vid", insert_default_tokens=False)
    for c in clips:
        speaker.index_word(c["vid"])
    cfg = Config.from_yaml(ROOT / "configs" / "hierarchy.yaml", batch_size=2,
                           hidden_size=16, n_layers=LAYERS, wordembed_dim=16,
                           random_seed=0, epochs=1)
    samples = window_clips(clips, TED_GESTURE, lang, speaker,
                           cfg.mean_pose_array, cfg.mean_dir_vec_array)
    return Trainer(cfg, samples, samples, lang, speaker, device="cpu")


def test_train_epoch_spans(trainer):
    steps = len(trainer.train_loader)
    assert steps >= 2
    first = trainer.global_iter
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(trainer.cfg.loss_warmup + 1)    # the GAN phase
    ranges = _ranges(prof)
    step_ranges = [r for r in ranges if r[0].startswith("train_step#")]
    assert [r[0] for r in step_ranges] == \
        [f"train_step#{first + i}" for i in range(steps)]
    for step in step_ranges:
        inside = {r[0] for r in ranges if r[0].startswith("ha2g.train.")
                  and _inside(r, step)}
        assert inside == TRAIN_NAMES
    assert {r[0] for r in ranges if r[0].startswith("ha2g.train.")} \
        == TRAIN_NAMES
    waits = [r for r in ranges if r[0] == "ha2g.trainer.loader_wait"]
    # one before each step, and the epoch's closing next(), which ends
    # the loader's iteration
    assert len(waits) == steps + 1
    for wait, step in zip(waits, step_ranges):
        assert wait[2] <= step[1]
    assert sum(r[0] == "ha2g.trainer.read" for r in ranges) == 1
