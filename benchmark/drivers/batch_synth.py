"""Batch synthesis: closed loop, calls back to back, each one
``prepare_fused`` plus ``run_fused`` over a batch of mu-law clips with
their transcripts and speakers, the poses pulled as the traffic says.

Inputs: a ring of distinct batches made from the seed in set-up (audio
as syllable-rate modulated noise, G.711 mu-law; words at ``words_per_s``,
Zipf-distributed over the vocabulary; speakers uniform).  Each call's
speaker-z noise comes from a generator seeded from the run's seed and the
call's number.

Check: for ``check_calls`` calls (the window's first, and others drawn
from the seed), ``check_rows`` clips drawn from the seed are synthesized
again by the float32 reference with the same weights, inputs and noise;
the number compared is the worst clip's RMS error over the reference's
RMS.  Every call's shape and finiteness is counted in ``bad_units``.
The control (``control``) gives the same number with the reference in
float8 in the program's place, its poses pulled as the program's are.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import harness
from reference.precision import FLOAT32, Precision, exact_float32
from reference.steps import synthesize, window_plan


def _clip_audio(gen, n_clips, n, device):
    """Syllable-rate modulated noise, per-clip loudness, as mu-law bytes."""
    t = torch.arange(n, device=device, dtype=torch.float32) / 16000
    rate = 3.0 + 3.0 * torch.rand((n_clips, 1), generator=gen, device=device)
    phase = 6.3 * torch.rand((n_clips, 1), generator=gen, device=device)
    loud = torch.exp(torch.empty((n_clips, 1), device=device).uniform_(
        np.log(0.02), np.log(0.5), generator=gen))
    env = 0.1 + torch.sin(rate * t * 6.2832 + phase).abs()
    x = torch.randn((n_clips, n), generator=gen, device=device) * env * loud
    x = x.clamp(-1.0, 1.0)
    y = torch.sign(x) * torch.log1p(255.0 * x.abs()) / np.log1p(255.0)
    return ((y + 1.0) / 2.0 * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def _transcripts(rng, n_clips, seconds, words_per_s, word_s, vocab):
    out = []
    for _ in range(n_clips):
        k = rng.poisson(words_per_s * seconds)
        starts = np.sort(rng.uniform(0.0, seconds - word_s, k))
        ids = np.minimum(rng.zipf(1.3, k), vocab) - 1
        out.append([(harness.word(int(i)), float(s), float(s + word_s))
                    for i, s in zip(ids, starts)])
    return out


class State:
    pass


def setup(run) -> State:
    from ha2g_torch.synthesis import make_synthesizer
    from ha2g_torch.train.hierarchy import HierarchySystem

    cfg, tr, dev = run.config, run.traffic, run.device
    st = State()
    st.run = run
    phase = harness.Phases("set-up")
    B, secs = tr["clips"], tr["clip_seconds"]
    st.n_samples = int(secs * 16000)
    plan = window_plan(cfg, st.n_samples)
    st.frames = cfg["n_poses"] + (plan["W"] - 1) * (cfg["n_poses"] - cfg["n_pre_poses"])
    st.windows = plan["W"]
    weights = harness.make_weights(harness.reference_model(cfg, dev),
                                   harness.sub_seed(run.seed, 1), dev)
    st.weights = {k: v.cpu() for k, v in weights.items()}
    phase("weights")
    gen = torch.Generator(dev).manual_seed(harness.sub_seed(run.seed, 2))
    rng = np.random.default_rng(harness.sub_seed(run.seed, 3))
    st.audio, st.words, st.vids, st.rows = [], [], [], []
    for _ in range(tr["ring"]):
        st.audio.append(_clip_audio(gen, B, st.n_samples, dev))
        st.words.append(_transcripts(rng, B, secs, tr["words_per_s"],
                                     tr["word_seconds"], cfg["n_words"] - 4))
        st.vids.append(rng.integers(0, cfg["n_speakers"], B))
        st.rows.append(np.sort(rng.choice(B, tr["check_rows"], replace=False)))
    phase("inputs")
    st.lang, _ = harness.vocabularies(cfg)
    system = HierarchySystem(harness.program_config(cfg), cfg["n_words"],
                             cfg["n_speakers"], device=dev)
    st.synth = make_synthesizer(system, weights)
    del weights, system
    st.out_dtype = np.dtype(tr["out_dtype"])
    st.kept, st.bad, st.calls = [], 0, 0
    phase("program")
    for k in range(tr["warmup_calls"]):
        _call(st, -1 - k, keep=False)
        phase(f"call {k + 1}")
    phase.done()
    return st


def _call(st, k: int, keep: bool = True) -> None:
    """Call number k (negative: a warm-up call) on ring batch k mod ring."""
    run = st.run
    b = k % len(st.audio)
    gen = torch.Generator(run.device).manual_seed(harness.sub_seed(run.seed, 7, k % 2 ** 31))
    plan = st.synth.prepare_fused(st.words[b], st.lang, st.vids[b],
                                  st.n_samples, generator=gen)
    out = st.synth.run_fused(st.audio[b], plan, out_dtype=st.out_dtype)
    ok = out.shape == (len(st.vids[b]), st.frames, st.synth.spec.pose_dim) \
        and bool(np.isfinite(out.sum()))
    st.bad += not ok
    if keep:
        st.kept.append(out[st.rows[b]].copy() if ok else None)


def window(st, seconds: float) -> dict:
    t0 = t = time.perf_counter()
    unit_s = []
    while True:
        _call(st, st.calls)
        st.calls += 1
        now = time.perf_counter()
        unit_s.append(now - t)
        t = now
        if t - t0 >= seconds:
            break
    elapsed = t - t0
    B = st.run.traffic["clips"]
    st.rate = st.calls / elapsed
    return {"frames_per_s": st.calls * B * st.frames / elapsed,
            "attempted": st.calls, "failed": st.bad, "unit_s": unit_s}


def traced(st) -> int:
    """The traced segment: ``trace_calls`` more calls (not checked)."""
    n = st.run.traffic["trace_calls"]
    for i in range(n):
        _call(st, 10 ** 6 + i, keep=False)
    return n


def release(st) -> None:
    del st.synth
    harness.release(st.run.device)


def work(st) -> dict:
    """The hand kernels' work in one call, for the rooflines: B1 forward
    launches as (T, B, H, bytes an element, count)."""
    from reference.skeletons import SKELETONS
    cfg = st.run.config
    n = st.windows * SKELETONS[cfg["dataset"]].n_levels * cfg["n_layers"]
    return {"b1_fwd": [(cfg["n_poses"], st.run.traffic["clips"],
                        cfg["hidden_size"], 2, n)]}


def check_calls(st) -> list:
    """The window's first call and ``check_calls - 1`` more drawn from the
    seed."""
    rng = np.random.default_rng(harness.sub_seed(st.run.seed, 4))
    more = rng.permutation(np.arange(1, st.calls))[:st.run.traffic["check_calls"] - 1]
    return [0] + sorted(int(k) for k in more)


def reference_poses(st, model, k: int, p: Precision = FLOAT32):
    run = st.run
    b = k % len(st.audio)
    rows = st.rows[b]
    gen = torch.Generator(run.device).manual_seed(harness.sub_seed(run.seed, 7, k % 2 ** 31))
    audio = torch.from_numpy(st.audio[b][rows]).to(run.device)
    with exact_float32():
        return synthesize(model, audio, [st.words[b][r] for r in rows],
                          st.vids[b][rows], gen, rows, len(st.vids[b]),
                          harness.index_of, p).cpu().numpy()


def worst_clip_error(got: np.ndarray, want: np.ndarray) -> float:
    err = np.sqrt(((got - want) ** 2).mean(axis=(1, 2)))
    return float((err / np.sqrt((want ** 2).mean(axis=(1, 2)))).max())


def check(st, count_flops: bool = False) -> dict:
    """-> the numbers compared, and with ``count_flops`` the model FLOPs of
    one call (the reference's count on the checked rows, scaled to the
    batch)."""
    model = harness.reference_model(st.run.config, st.run.device, st.weights)
    worst, flops = 0.0, None
    for i, k in enumerate(check_calls(st)):
        if st.kept[k] is None:
            continue
        if count_flops and i == 0:
            with harness.flop_counter() as fc:
                want = reference_poses(st, model, k)
            flops = fc.get_total_flops() * st.run.traffic["clips"] / len(st.rows[0])
        else:
            want = reference_poses(st, model, k)
        worst = max(worst, worst_clip_error(st.kept[k], want))
    return {"numbers": {"worst_clip_rel_err": worst, "bad_units": float(st.bad)},
            "flops_per_unit": flops}


def control(st, p: Precision) -> dict:
    """The number with the reference in ``p`` in the program's place."""
    model = harness.reference_model(st.run.config, st.run.device, st.weights)
    worst = 0.0
    for k in check_calls(st):
        want = reference_poses(st, model, k)
        got = reference_poses(st, model, k, p).astype(st.out_dtype)
        worst = max(worst, worst_clip_error(got.astype(np.float32), want))
    return {"worst_clip_rel_err": worst}
