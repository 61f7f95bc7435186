"""Assembly of the built dataset (the port of
ha2g_tpu/dataset_pipeline/assemble.py; reference
dataset_script/script/make_ted_dataset.py).

For each valid scene of each video: the words whose start lies in the
scene, the 16 kHz audio slice, its log-mel spectrogram as float16
(``ops/mel.log_mel_np``; the reference uses librosa at n_fft 1024 / hop
512, make_ted_dataset.py:121-123) and the 3D skeletons; train / val / test
8 / 1 / 1 by clip index mod 10 (make_ted_dataset.py:130-139), written as
clip storage (``data/storage.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ha2g_torch.data.storage import save_clips
from ha2g_torch.ops.mel import log_mel_np

SR = 16000


def split_clips(n_clips: int) -> list[str]:
    """The split of each clip index: index mod 10 is 0 -> val, 1 -> test,
    else train (make_ted_dataset.py:130-139)."""
    out = []
    for i in range(n_clips):
        r = i % 10
        out.append("val" if r == 0 else "test" if r == 1 else "train")
    return out


def assemble_clips(videos: Sequence[dict], out_dir: str,
                   video_fps: float = 25.0,
                   compute_spec: bool = True) -> dict[str, int]:
    """videos: dicts of
        vid: str
        audio: (n_samples,) float32 at 16 kHz
        words: [(word, start_s, end_s)] of the whole video
        scenes: [(start_frame, end_frame, skeletons_3d (F, n_joints, 3))]
    Writes <out_dir>/{train,val,test}/ clip storage (a split with no clip
    is not written); -> the clips of each split.  Scenes shorter than a
    second of audio are skipped.
    """
    splits: dict[str, list] = {"train": [], "val": [], "test": []}
    clip_idx = 0
    for video in videos:
        audio = np.asarray(video["audio"], np.float32)
        for (s_f, e_f, skel) in video["scenes"]:
            s_t, e_t = s_f / video_fps, e_f / video_fps
            clip_audio = audio[int(s_t * SR):int(e_t * SR)]
            if len(clip_audio) < SR:
                continue
            words = [w for w in video["words"] if s_t <= w[1] <= e_t]
            spec = log_mel_np(clip_audio).astype(np.float16) \
                if compute_spec else None
            splits[split_clips(clip_idx + 1)[clip_idx]].append({
                "vid": video["vid"],
                "skeletons_3d": np.asarray(skel, np.float32),
                "audio_raw": clip_audio,
                "audio_spec": spec,
                "words": words,
                "start_time": float(s_t), "end_time": float(e_t),
                "start_frame_no": int(s_f), "end_frame_no": int(e_f),
            })
            clip_idx += 1

    counts = {}
    for name, clips in splits.items():
        if clips:
            save_clips(Path(out_dir) / name, clips)
        counts[name] = len(clips)
    return counts
