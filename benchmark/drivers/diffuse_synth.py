"""Diffusion batch synthesis: closed loop, calls back to back, each one
``DiffusionSynthesizer.generate`` over a batch of mu-law clips (the model
reads the audio alone: no transcript, speaker 0), its poses pulled as
float32.  Every window is the guided denoising chain from fresh noise.

Inputs: a ring of distinct batches made from the seed in set-up, the
audio as ``batch_synth`` makes it (syllable-rate modulated noise, G.711
mu-law).  Each call's noise comes from a generator on the device seeded
from the run's seed and the call's number.

Check: ``check_rows`` clips of the window's first call, drawn from the
seed, synthesized again by the float32 reference with the same weights,
audio and noise.  ``worst_clip_rel_err``: the worst clip's RMS error over
the reference's RMS, the reference running the whole clip from its own
carry.  ``worst_window_rel_err``: the worst window's, the reference
restarted at each window from the program's seed frames (the last n_pre
frames of the program's previous window), so one window's steps are
compared apart from what the carry brings in.  Every call's shape and
finiteness is counted in ``bad_units``.  The control (``control``) gives
both with the reference in float8 in the program's place.

Traced segment: one window of one call (a call is thousands of steps).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import harness
from drivers.batch_synth import _clip_audio
from reference.diffgesture import DiffGesture, synthesize
from reference.precision import Precision, exact_float32
from reference.steps import window_plan


class State:
    pass


def reference_model(cfg: dict, device, weights=None):
    """The reference DiffGesture: on the meta device without ``weights``
    (shapes only), else on ``device`` holding them."""
    if weights is None:
        with torch.device("meta"):
            return DiffGesture(cfg)
    model = DiffGesture(cfg)
    model.load_state_dict(weights, strict=True)
    return model.to(device).eval()


def call_flops(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one call: one denoiser pass and one audio-encoder
    call over the batch, counted on the meta device under FlopCounterMode,
    times the passes (two a step) and the windows."""
    B, T = traffic["clips"], cfg["n_poses"]
    n_samples = int(traffic["clip_seconds"] * 16000)
    model = reference_model(cfg, None)
    cond = cfg["pose_dim"] + 1 + 32
    with torch.device("meta"):
        x = torch.empty((B, T, cfg["pose_dim"] + 3 + cond))
        wav = torch.empty((B, int(T / cfg["motion_resampling_framerate"] * 16000)))
    with harness.flop_counter() as fc:
        model.denoiser(x)
    per_pass = fc.get_total_flops()
    with harness.flop_counter() as fc:
        model.audio_encoder(wav)
    W = window_plan(cfg, n_samples)["W"]
    return float(W * (2 * cfg["diffusion_steps"] * per_pass
                      + fc.get_total_flops()))


def setup(run) -> State:
    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.synthesis import make_synthesizer
    from ha2g_torch.train.diffusion import DiffusionSystem

    cfg, tr, dev = run.config, run.traffic, run.device
    st = State()
    st.run = run
    phase = harness.Phases("set-up")
    B = tr["clips"]
    st.n_samples = int(tr["clip_seconds"] * 16000)
    st.windows = window_plan(cfg, st.n_samples)["W"]
    st.frames = cfg["n_poses"] + (st.windows - 1) * (cfg["n_poses"] - cfg["n_pre_poses"])
    weights = harness.make_weights(reference_model(cfg, dev),
                                   harness.sub_seed(run.seed, 1), dev)
    st.weights = {k: v.cpu() for k, v in weights.items()}
    phase("weights")
    gen = torch.Generator(dev).manual_seed(harness.sub_seed(run.seed, 2))
    rng = np.random.default_rng(harness.sub_seed(run.seed, 3))
    st.audio = [_clip_audio(gen, B, st.n_samples, dev) for _ in range(tr["ring"])]
    st.rows = np.sort(rng.choice(B, tr["check_rows"], replace=False))
    phase("inputs")
    system = DiffusionSystem(harness.program_config(cfg), device=dev)
    st.synth = make_synthesizer(system, weights)
    del weights, system
    st.lang, st.vids, st.words = Vocab("words"), np.zeros(B, np.int64), [[]] * B
    st.kept, st.kept_windows, st.bad, st.calls = None, [], 0, 0
    phase("program")
    for k in range(tr["warmup_calls"]):
        _call(st, -1 - k)
        phase(f"call {k + 1}")
    phase.done()
    return st


def _generator(st, k: int) -> torch.Generator:
    run = st.run
    return torch.Generator(run.device).manual_seed(
        harness.sub_seed(run.seed, 7, k % 2 ** 31))


def _call(st, k: int, samples=None) -> None:
    """Call number k (negative: a warm-up call) on ring batch k mod ring;
    call 0 keeps the checked rows' poses and each window's output."""
    synth = st.synth
    audio = st.audio[k % len(st.audio)]
    if samples is not None:
        audio = audio[:, :samples]
    if k == 0:
        rows = torch.as_tensor(st.rows, device=st.run.device)
        step = synth.window_step

        def keeping(inputs, generator):
            out = step(inputs, generator)
            st.kept_windows.append(out[rows].cpu())
            return out
        synth.window_step = keeping
    try:
        out = synth.generate(audio, st.words, st.lang, st.vids,
                             generator=_generator(st, k))
    finally:
        synth.__dict__.pop("window_step", None)
    want = (len(st.vids), st.frames if samples is None else st.run.config["n_poses"],
            synth.spec.pose_dim)
    ok = out.shape == want and bool(np.isfinite(out.sum()))
    st.bad += not ok
    if k == 0:
        st.kept = out[st.rows].copy() if ok else None


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
    st.rate = st.calls / elapsed
    return {"frames_per_s": st.calls * st.run.traffic["clips"] * st.frames / elapsed,
            "attempted": st.calls, "failed": st.bad, "unit_s": unit_s}


def traced(st) -> int:
    """The traced segment: one window of one more call (not checked): the
    ring's first batch cut to one window's samples."""
    cfg = st.run.config
    _call(st, 10 ** 6, samples=int(cfg["n_poses"] / cfg["motion_resampling_framerate"]
                                   * 16000))
    return 1


def release(st) -> None:
    del st.synth
    harness.release(st.run.device)


def work(st) -> dict:
    """One window's attention for ``attn_roofline.diffuse``: (sequences,
    heads, frames, head width, launches): both guided passes' rows, every
    block of every step."""
    cfg = st.run.config
    H = cfg["n_heads"]
    return {"attn": [(2 * st.run.traffic["clips"], H, cfg["n_poses"],
                      cfg["diff_hidden_dim"] // H,
                      cfg["block_depth"] * cfg["diffusion_steps"])]}


def _rel(got, want) -> float:
    """The worst row's RMS error over the reference's RMS."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.sqrt(((got - want) ** 2).mean(axis=(1, 2)))
    return float((err / np.sqrt((want ** 2).mean(axis=(1, 2)))).max())


def _numbers(st, model, poses, wins) -> dict:
    """Both numbers for ``poses`` and per-window outputs ``wins`` (call 0's
    rows), each played against the float32 reference: the chained rows
    and the restarted ones run as one batch."""
    run, n = st.run, st.run.config["n_pre_poses"]
    audio = torch.from_numpy(st.audio[0][st.rows]).to(run.device)
    seeds = [torch.zeros_like(wins[0][:, :n])] + [w[:, -n:] for w in wins[:-1]]
    with exact_float32():
        want, _, restarted = synthesize(
            model, audio, _generator(st, 0), st.rows, run.traffic["clips"],
            seeds=[s.to(run.device) for s in seeds])
    return {"worst_clip_rel_err": _rel(poses, want.cpu()),
            "worst_window_rel_err": max(_rel(w, r.cpu())
                                        for w, r in zip(wins, restarted))}


def check(st, count_flops: bool = False) -> dict:
    """-> the numbers compared, and with ``count_flops`` the model FLOPs of
    one call."""
    numbers = {"worst_clip_rel_err": float("inf"),
               "worst_window_rel_err": float("inf")}
    if st.kept is not None:
        model = reference_model(st.run.config, st.run.device, st.weights)
        numbers = _numbers(st, model, st.kept, st.kept_windows)
    flops = call_flops(st.run.config, st.run.traffic) if count_flops else None
    return {"numbers": {**numbers, "bad_units": float(st.bad)},
            "flops_per_unit": flops}


def control(st, p: Precision) -> dict:
    """The numbers with the reference in ``p`` in the program's place."""
    model = reference_model(st.run.config, st.run.device, st.weights)
    audio = torch.from_numpy(st.audio[0][st.rows]).to(st.run.device)
    with exact_float32():
        poses, wins, _ = synthesize(model, audio, _generator(st, 0), st.rows,
                                    st.run.traffic["clips"], p)
    return _numbers(st, model, poses.cpu(), [w.cpu() for w in wins])
