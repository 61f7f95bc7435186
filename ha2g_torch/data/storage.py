"""On-disk clip storage (the port of ha2g_tpu/data/storage.py; the same
format, so clips written by one package load in the other).  A directory
per split holds

  clips.json  per-clip metadata: vid, start / end time, frame numbers,
              words;
  clips.npz   the skeletons_3d / audio_raw (+ optional audio_spec) arrays,
              keyed skel_%d / audio_%d / spec_%d.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def save_clips(path, clips: list[dict]) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta, arrays = [], {}
    for i, c in enumerate(clips):
        meta.append({"vid": c["vid"], "words": c["words"],
                     "start_time": c["start_time"],
                     "end_time": c["end_time"],
                     "start_frame_no": c.get("start_frame_no", 0),
                     "end_frame_no": c.get("end_frame_no", 0),
                     "has_spec": c.get("audio_spec") is not None})
        arrays[f"skel_{i}"] = np.asarray(c["skeletons_3d"], np.float32)
        arrays[f"audio_{i}"] = np.asarray(c["audio_raw"], np.float32)
        if c.get("audio_spec") is not None:
            arrays[f"spec_{i}"] = np.asarray(c["audio_spec"], np.float16)
    (path / "clips.json").write_text(json.dumps(meta))
    np.savez_compressed(path / "clips.npz", **arrays)


def load_clips(path) -> list[dict]:
    path = Path(path)
    meta = json.loads((path / "clips.json").read_text())
    arrays = np.load(path / "clips.npz")
    return [{
        "vid": m["vid"],
        "words": [tuple(w) for w in m["words"]],
        "start_time": m["start_time"], "end_time": m["end_time"],
        "start_frame_no": m["start_frame_no"],
        "end_frame_no": m["end_frame_no"],
        "skeletons_3d": arrays[f"skel_{i}"],
        "audio_raw": arrays[f"audio_{i}"],
        "audio_spec": arrays[f"spec_{i}"].astype(np.float32)
        if m["has_spec"] else None,
    } for i, m in enumerate(meta)]


def merge_clips(src_dirs, out_dir) -> int:
    """Concatenate clip stores into one, in the order given (the
    reference's dataset_script/script/merge_dataset.py); -> the clip
    count."""
    clips = []
    for d in src_dirs:
        clips.extend(load_clips(d))
    save_clips(out_dir, clips)
    return len(clips)
