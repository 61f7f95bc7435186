"""Synthetic clips for tests and smoke runs (the port of
ha2g_tpu/data/synthetic.py; the same seed gives the same arrays).

Clip records have the schema of the TED datasets: smooth speaker-dependent
arm motion built by forward kinematics from perturbed mean direction
vectors (so the motion filter passes), noise audio with beats, and timed
word lists.
"""

from __future__ import annotations

import numpy as np

from ha2g_torch.skeleton import SkeletonSpec

SR = 16000

_WORDS = ("the quick brown fox jumps over lazy dog people think about "
          "ideas worth spreading today tomorrow energy future world life "
          "technology science art music hand gesture motion speech").split()


def default_mean_dir_vec(spec: SkeletonSpec, seed: int = 1234) -> np.ndarray:
    """A plausible resting-pose direction-vector mean: spine down, unit
    vectors."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(spec.n_bones, 3)) * 0.3
    v[0] = [0.0, -1.0, 0.0]  # spine points down (the filter checks it)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return v.reshape(-1).astype(np.float32)


def _accum(spec: SkeletonSpec) -> np.ndarray:
    """(n_bones, n_joints) 0/1 path matrix."""
    m = np.zeros((spec.n_bones, spec.n_joints), dtype=np.float32)
    for b, (parent, child, _) in enumerate(spec.bones):
        m[:, child] = m[:, parent]
        m[b, child] = 1.0
    return m


def synthetic_clips(spec: SkeletonSpec, n_clips: int = 8,
                    clip_seconds: float = 8.0, n_speakers: int = 4,
                    fps: int = 15, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    mean_vec = default_mean_dir_vec(spec).reshape(spec.n_bones, 3)
    clips = []
    for c in range(n_clips):
        n_frames = int(clip_seconds * fps)
        t = np.arange(n_frames) / fps
        # per-bone sinusoidal perturbation of the mean direction vectors
        freq = rng.uniform(0.3, 1.2, size=(spec.n_bones, 3))
        phase = rng.uniform(0, 2 * np.pi, size=(spec.n_bones, 3))
        amp = rng.uniform(0.05, 0.35, size=(spec.n_bones, 3))
        vec = mean_vec[None] + amp[None] * np.sin(
            2 * np.pi * freq[None] * t[:, None, None] + phase[None])
        vec[:, 0] = [0.0, -1.0, 0.0]  # keep the spine upright
        vec /= np.linalg.norm(vec, axis=2, keepdims=True)
        pose = np.einsum("fbd,bj->fjd", vec * spec.lengths[None, :, None],
                         _accum(spec))

        n_samples = int(clip_seconds * SR)
        noise = rng.normal(size=n_samples).astype(np.float32) * 0.05
        beat = np.sin(2 * np.pi * 220 * np.arange(n_samples) / SR) * \
            (np.sin(2 * np.pi * 2.0 * np.arange(n_samples) / SR) > 0.9)
        audio = (noise + 0.2 * beat.astype(np.float32))

        n_words = rng.integers(6, 14)
        starts = np.sort(rng.uniform(0, clip_seconds - 0.5, n_words))
        words = [(str(rng.choice(_WORDS)), float(s), float(s + 0.3))
                 for s in starts]

        clips.append({
            "vid": f"speaker_{c % n_speakers}",
            "skeletons_3d": pose.astype(np.float32),
            "audio_raw": audio,
            "audio_spec": None,
            "words": words,
            "start_time": 0.0,
            "end_time": clip_seconds,
            "start_frame_no": 0,
            "end_frame_no": n_frames,
        })
    return clips
