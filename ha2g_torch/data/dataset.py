"""The windowed speech-motion dataset (the port of
ha2g_tpu/data/dataset.py, numpy only; the same clips give the same arrays).

The reference's two stages (DataPreprocessor, data_preprocessor.py:69-167,
and SpeechMotionDataset.__getitem__, lmdb_data_loader.py:108-176) run once
on the host into fixed-shape arrays: resample skeletons to 15 fps, window
them into n_poses * 1.25 chunks at the subdivision stride, slice the
aligned spectrogram and raw-audio windows with symmetric padding, filter
the motion, turn poses into unit direction vectors minus the dataset
mean, clip to n_poses frames, and build the frame-aligned word indices and
the SOS/EOS word sequence.  The per-clip motion part (resample, windows,
filter, direction vectors) runs in the native C++ engine
(``ha2g_torch/native``) when it is available, as in the JAX package, else
in numpy; the engine's targets agree with numpy's within 2e-5 and every
other array is equal (``use_native=False`` picks the numpy path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import numpy as np

from ha2g_torch.data.vocab import EOS_TOKEN, SOS_TOKEN, Vocab
from ha2g_torch.skeleton import SkeletonSpec

SR = 16000
# a sample's word sequence, SOS and EOS included, is cut to this length
MAX_WORDS = 32


def spectrogram_length_for(n_frames: int, fps: int) -> int:
    """(n/fps*16000 - 1024)/512 + 1  (reference data_utils.py:41-43)."""
    return int(round((n_frames / fps * SR - 1024) / 512 + 1))


def resample_pose_seq(poses: np.ndarray, duration_in_sec: float,
                      fps: int) -> np.ndarray:
    """Linear resampling (reference data_utils.py:46-56)."""
    n = len(poses)
    expected_n = duration_in_sec * fps
    x_new = np.arange(0, n, n / expected_n)
    idx0 = np.clip(np.floor(x_new).astype(int), 0, n - 1)
    idx1 = np.clip(idx0 + 1, 0, n - 1)
    frac = (x_new - np.floor(x_new)).reshape((-1,) + (1,) * (poses.ndim - 1))
    out = poses[idx0] * (1 - frac) + poses[idx1] * frac
    return out.astype(poses.dtype)


class MotionFilter:
    """Window quality filter (motion_preprocessor.py:4-86 and its
    expressive twin).  ``static_joints``: the wrist joints, (6, 9) for TED
    Gesture, (6, 7) for TED Expressive."""

    def __init__(self, mean_pose: np.ndarray,
                 static_joints: tuple[int, int] = (6, 9)):
        self.mean_pose = mean_pose.reshape(-1, 3)
        self.static_joints = static_joints

    def check(self, skeletons: np.ndarray) -> str:
        """'PASS' or the reason for rejecting the window."""
        if np.mean(np.abs(skeletons - self.mean_pose)) < 0.02:
            return "pose"
        spine = skeletons[:, 1] - skeletons[:, 0]
        spine = spine / np.linalg.norm(spine, axis=1, keepdims=True)
        angles = np.arccos(np.clip(-spine[:, 1], -1.0, 1.0))
        if np.rad2deg(np.max(angles)) > 30 or np.rad2deg(np.mean(angles)) > 20:
            return "spine angle"
        th = 0.0014
        var = [np.sum(np.var(skeletons[:, j], axis=0))
               for j in self.static_joints]
        if all(v < th for v in var):
            return "motion"
        if np.isnan(skeletons).any():
            return "nan"
        return "PASS"


@dataclasses.dataclass
class WindowedSamples:
    """Fixed-shape sample arrays, ready to batch."""

    text: np.ndarray          # (N, n_poses) int32 frame-aligned word indices
    word_seq: np.ndarray      # (N, max_words) int32 SOS..EOS, zero-padded
    word_lengths: np.ndarray  # (N,) int32
    pose: np.ndarray          # (N, n_poses, n_joints*3) float32
    target: np.ndarray        # (N, n_poses, pose_dim) float32 dir vecs - mean
    audio: np.ndarray         # (N, audio_len) float32
    spec: np.ndarray          # (N, 128, spec_len) float32
    vids: np.ndarray          # (N,) int32 speaker indices

    def __len__(self):
        return self.text.shape[0]


def _pose_to_dir_vec_np(pose: np.ndarray, spec: SkeletonSpec) -> np.ndarray:
    """Host-side inverse kinematics (reference
    convert_pose_seq_to_dir_vec, data_utils.py:101-120)."""
    pose = pose.reshape(pose.shape[0], spec.n_joints, 3)
    d = pose[:, spec.children] - pose[:, spec.parents]
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(norm > 1e-12, d / np.maximum(norm, 1e-12), d)


def frame_word_indices(words, start: float, frame_duration: float,
                       n_poses: int, lang: Vocab,
                       remove_word_timing: bool = False) -> np.ndarray:
    """A window's words as vocabulary indices on its n_poses frames
    (lmdb_data_loader.py:116-141): each word on the frame where it starts,
    or with ``remove_word_timing`` the words that start inside the window
    spread evenly over it."""
    ext = np.zeros(n_poses, np.int32)
    frames = [int(np.floor((w[1] - start) / frame_duration)) for w in words]
    if remove_word_timing:
        inside = [w for w, f in zip(words, frames) if f < n_poses]
        space = int(n_poses / (len(inside) + 1))
        for k, w in enumerate(inside):
            ext[(k + 1) * space] = lang.get_word_index(w[0])
    else:
        for w, f in zip(words, frames):
            if f < n_poses:
                ext[max(f, 0)] = lang.get_word_index(w[0])
    return ext


def window_clips(clips: Iterable[dict], spec: SkeletonSpec,
                 lang: Vocab, speaker: Vocab, mean_pose: np.ndarray,
                 mean_dir_vec: np.ndarray, n_poses: int = 34,
                 subdivision_stride: int = 10, fps: int = 15,
                 static_joints: tuple[int, int] = (6, 9),
                 use_native: Optional[bool] = None) -> WindowedSamples:
    """The whole windowing pipeline over clip records.

    Each clip: skeletons_3d (F, n_joints, 3), audio_raw (n,), audio_spec
    (128, S) or None (then its log-mel is computed here), words
    [(word, start_t, end_t)], start_time, end_time, vid.  ``use_native``:
    the C++ engine for the motion part; None means the engine where it is
    available (``native.available()``).
    """
    from ha2g_torch import native
    from ha2g_torch.ops.mel import log_mel_np

    if use_native is None:
        use_native = native.available()

    n_ext = int(round(n_poses * 1.25))
    audio_len_ext = int(round(n_ext / fps * SR))
    spec_len_ext = spectrogram_length_for(n_ext, fps)
    audio_len = int(round(n_poses / fps * SR))
    spec_len = spectrogram_length_for(n_poses, fps)
    mfilter = MotionFilter(mean_pose, static_joints)

    rows = {k: [] for k in ("text", "word_seq", "pose", "target", "audio",
                            "spec", "vids")}

    for clip in clips:
        duration = clip["end_time"] - clip["start_time"]
        raw_skel = np.asarray(clip["skeletons_3d"], np.float32)
        audio_raw = np.asarray(clip["audio_raw"], np.float32)
        if clip.get("audio_spec") is not None:
            clip_spec = np.asarray(clip["audio_spec"], np.float32)
        else:
            clip_spec = log_mel_np(audio_raw).astype(np.float32)
        word_list = clip["words"]
        vid_idx = speaker.get_word_index(clip["vid"])

        # the windows that pass the motion filter: (start, frames of the
        # resampled clip, the window's n_poses frames, target or None)
        if use_native:
            targets, poses, starts = native.window_clip_native(
                raw_skel.reshape(len(raw_skel), spec.n_joints, 3), duration,
                fps, spec, mean_dir_vec, mean_pose, n_poses, n_ext,
                subdivision_stride, static_joints)
            # the resampled clip's length, by the engine's formula
            n_skel = int(np.ceil(len(raw_skel)
                                 / (len(raw_skel) / (duration * fps))))
            candidates = [
                (int(s), n_skel, p.reshape(n_poses, spec.n_joints, 3), t)
                for t, p, s in zip(targets, poses, starts)]
        else:
            skel = resample_pose_seq(raw_skel, duration, fps)
            num_subdivision = math.floor((len(skel) - n_ext)
                                         / subdivision_stride) + 1
            candidates = []
            for i in range(max(num_subdivision, 0)):
                start_idx = i * subdivision_stride
                win = skel[start_idx:start_idx + n_ext]
                if mfilter.check(win) == "PASS":
                    candidates.append((start_idx, len(skel), win[:n_poses],
                                       None))

        for start_idx, n_skel, sample_skel_c, target in candidates:
            fin_idx = start_idx + n_ext
            sub_start = clip["start_time"] + start_idx / fps
            sub_end = clip["start_time"] + fin_idx / fps
            words = [w for w in word_list
                     if w[1] >= sub_start and w[1] <= sub_end]
            if len(words) < 2:
                continue

            # aligned spectrogram window (data_preprocessor.py:106-115)
            a0 = math.floor(start_idx / n_skel * clip_spec.shape[1])
            a1 = a0 + spec_len_ext
            cs = clip_spec
            if a1 > cs.shape[1]:
                cs = np.pad(cs, ((0, 0), (0, a1 - cs.shape[1])),
                            mode="symmetric")
            sample_spec = cs[:, a0:a1]

            # aligned raw audio window (data_preprocessor.py:117-128)
            r0 = math.floor(start_idx / n_skel * len(audio_raw))
            r1 = r0 + audio_len_ext
            ar = audio_raw
            if r1 > len(ar):
                ar = np.pad(ar, (0, r1 - len(ar)), mode="symmetric")
            sample_audio = ar[r0:r1]

            # __getitem__-stage clipping (lmdb_data_loader.py:155-162)
            sample_end_time = sub_start + (sub_end - sub_start) * \
                n_poses / n_ext
            sample_audio_c = sample_audio[:audio_len]
            if len(sample_audio_c) < audio_len:
                sample_audio_c = np.pad(
                    sample_audio_c, (0, audio_len - len(sample_audio_c)),
                    mode="symmetric")
            sample_spec_c = sample_spec[:, :spec_len]

            # direction-vector target (data_preprocessor.py:157-158); the
            # engine made it already
            if target is None:
                dvec = _pose_to_dir_vec_np(sample_skel_c, spec)
                target = (dvec.reshape(n_poses, -1)
                          - mean_dir_vec.reshape(1, -1))

            ext = frame_word_indices(words, sub_start,
                                     (sample_end_time - sub_start) / n_poses,
                                     n_poses, lang)

            # SOS/EOS word sequence (lmdb_data_loader.py:143-150)
            seq = [SOS_TOKEN] + [lang.get_word_index(w[0]) for w in words
                                 if w[1] <= sample_end_time] + [EOS_TOKEN]
            seq = seq[:MAX_WORDS]

            rows["text"].append(ext)
            rows["word_seq"].append(np.asarray(seq, np.int32))
            rows["pose"].append(sample_skel_c.reshape(n_poses, -1))
            rows["target"].append(target.astype(np.float32))
            rows["audio"].append(sample_audio_c.astype(np.float32))
            rows["spec"].append(sample_spec_c.astype(np.float32))
            rows["vids"].append(vid_idx)

    n = len(rows["text"])
    if n == 0:
        raise ValueError("windowing produced no samples")
    lengths = np.asarray([len(s) for s in rows["word_seq"]], np.int32)
    mw = max(int(lengths.max()), 2)
    word_seq = np.zeros((n, mw), np.int32)
    for i, s in enumerate(rows["word_seq"]):
        word_seq[i, :len(s)] = s
    return WindowedSamples(
        text=np.stack(rows["text"]).astype(np.int32),
        word_seq=word_seq, word_lengths=lengths,
        pose=np.stack(rows["pose"]).astype(np.float32),
        target=np.stack(rows["target"]),
        audio=np.stack(rows["audio"]),
        spec=np.stack(rows["spec"]),
        vids=np.asarray(rows["vids"], np.int32))
