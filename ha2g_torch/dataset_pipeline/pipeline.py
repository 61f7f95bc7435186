"""The dataset-construction orchestrator (the port of
ha2g_tpu/dataset_pipeline/pipeline.py).

The reference runs its YouTube pipeline as scripts by hand, in order
(dataset_script/README.md:37-88: download_video, run_mp3,
run_openpose / run_expose, run_scenedetect, run_gentle, run_clip_filtering,
make_ted_dataset).  ``build_dataset`` chains the same steps a video with
the runners' resume from their artifacts, so a half-built work directory
goes on where it stopped, and a video whose outside tools are missing is
skipped with the reason logged instead of ending the batch.

Word timings, in this order (run_gentle.py / SubtitleWrapper):
  1. a forced alignment kept under <work>/align/ (gentle's output),
  2. else the YouTube auto-subtitle .vtt beside the video (``parse_vtt``,
     as SubtitleWrapper.load_auto_subtitle_data, data_utils.py:377-427:
     a cue's words split on <c>, each word's end its inline timestamp,
     its start the previous word's end),
  3. else no words: the video is skipped (make_ted_dataset.py:99-101).
"""

from __future__ import annotations

import logging
import re
import wave
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ha2g_torch.dataset_pipeline import runners
from ha2g_torch.dataset_pipeline.assemble import assemble_clips
from ha2g_torch.dataset_pipeline.filtering import (ClipFilter,
                                                   select_main_speaker)

_TS = re.compile(r"(\d+)?:?(\d{2}):(\d{2})[.,](\d{3})")


def _seconds(ts: str) -> float:
    m = _TS.match(ts)
    if not m:
        raise ValueError(f"bad timestamp {ts!r}")
    h, mi, s, ms = (int(g) if g else 0 for g in m.groups())
    return h * 3600 + mi * 60 + s + ms / 1000.0


def parse_vtt(path: str | Path) -> list[tuple[str, float, float]]:
    """A YouTube auto-subtitle .vtt -> [(word, start_s, end_s)].

    As SubtitleWrapper.load_auto_subtitle_data (data_utils.py:377-427):
    cue lines with inline <00:..> timestamps split on <c>; each piece's
    trailing timestamp is that word's end and its start is the previous
    word's end (the cue's start for the first; the last word ends at the
    cue's end).  A cue without inline timestamps spreads its words evenly
    over the cue.
    """
    words: list[tuple[str, float, float]] = []
    cue_start = cue_end = None
    for raw_line in Path(path).read_text(errors="replace").splitlines():
        line = raw_line.strip()
        if "-->" in line:
            parts = [p.strip() for p in line.split("-->")]
            cue_start = _seconds(parts[0].split()[0])
            cue_end = _seconds(parts[1].split()[0])
            continue
        if cue_start is None or not line or line.startswith(("WEBVTT",
                                                             "Kind:",
                                                             "Language:")):
            continue
        text = line.replace("</c>", "")
        text = re.sub(r"<c[.][\w.-]+>", "", text).replace("<c>", "\x00")
        if _TS.search(text):
            prev_end = cue_start
            for chunk in text.split("\x00"):
                if "<" in chunk:
                    word, ts = chunk.split("<", 1)
                    end = _seconds(ts.rstrip(">"))
                else:           # the line's last word ends at the cue's end
                    word, end = chunk, cue_end
                word = word.strip()
                if word:
                    words.append((word, prev_end, end))
                prev_end = end
        else:
            plain = [w for w in text.replace("\x00", " ").split() if w]
            if plain and cue_end > cue_start:
                dt = (cue_end - cue_start) / len(plain)
                for i, w in enumerate(plain):
                    words.append((w, cue_start + i * dt,
                                  cue_start + (i + 1) * dt))
    return words


def _read_wav(path: Path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        if w.getframerate() != 16000 or w.getnchannels() != 1:
            raise ValueError(f"{path}: want 16 kHz mono (extract_audio "
                             "writes this)")
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    return pcm.astype(np.float32) / 32768.0


def _words_for(vid: str, work: Path, audio_path: Path
               ) -> Optional[list[tuple[str, float, float]]]:
    try:
        return runners.align(str(audio_path), "", str(work))
    except (runners.StepUnavailable, ImportError, OSError,
            RuntimeError) as e:
        logging.debug("no forced alignment for %s: %s", vid, e)
    for pattern in (f"*{vid}*.vtt", f"{vid}.vtt"):
        hits = sorted((work / "videos").glob(pattern))
        if hits:
            return parse_vtt(hits[0])
    return None


def _frames(kp_path: Path) -> tuple[list, np.ndarray]:
    """The keypoints file: its frames (a ragged object array, hence
    ``allow_pickle``) and its skeletons."""
    kp = np.load(kp_path, allow_pickle=True)
    return list(kp["keypoints_2d"]), np.asarray(kp["skeletons_3d"],
                                                np.float32)


def process_video(vid: str, work: Path, fps: float = 25.0,
                  min_shoulder_px: float = 100.0) -> Optional[dict]:
    """download -> audio -> pose -> scenes -> words -> filter for one
    video; -> the record ``assemble_clips`` reads, or None (the reason
    logged) when a step cannot run or no scene passes."""
    try:
        video_path = runners.download(vid, str(work))
        audio_path = runners.extract_audio(str(video_path), str(work))
        kp_path = runners.pose_estimation(str(video_path), str(work))
        scene_bounds = runners.scene_detect(str(video_path), str(work))
    except runners.StepUnavailable as e:
        logging.warning("skip %s: %s", vid, e)
        return None

    words = _words_for(vid, work, audio_path)
    if not words:
        logging.warning("skip %s: no word timings (no alignment, no .vtt)",
                        vid)
        return None

    frames, skel3d = _frames(kp_path)
    valid_scenes = []
    n_rejected = 0
    for (s, e) in scene_bounds:
        scene = frames[s:e]
        if not scene:
            continue
        f = ClipFilter(scene, select_main_speaker(scene), fps=fps,
                       min_shoulder_px=min_shoulder_px)
        if f.is_correct_clip():
            valid_scenes.append((s, e, skel3d[s:e]))
        else:
            n_rejected += 1
            logging.info("%s scene [%d,%d): %s", vid, s, e, f.message)
    logging.info("%s: %d/%d scenes pass filtering", vid,
                 len(valid_scenes), len(valid_scenes) + n_rejected)
    if not valid_scenes:
        return None
    return {"vid": vid, "audio": _read_wav(audio_path), "words": words,
            "scenes": valid_scenes}


def build_dataset(video_ids: Sequence[str], work_dir: str, out_dir: str,
                  fps: float = 25.0, min_shoulder_px: float = 100.0,
                  qa_report: bool = False) -> dict:
    """The whole pipeline over video ids -> clip-storage splits under
    out_dir (and, with ``qa_report``, <out_dir>/qa_report.html of the
    filter's decisions on every scene).  -> {train / val / test clips,
    videos: processed, skipped: [ids], qa_report: path}."""
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    videos, skipped = [], []
    for vid in video_ids:
        rec = process_video(vid, work, fps=fps,
                            min_shoulder_px=min_shoulder_px)
        if rec is None:
            skipped.append(vid)
        else:
            videos.append(rec)

    counts = assemble_clips(videos, out_dir, video_fps=fps) if videos \
        else {"train": 0, "val": 0, "test": 0}
    result = {**counts, "videos": len(videos), "skipped": skipped}

    if qa_report and videos:
        from ha2g_torch.dataset_pipeline.report import (run_filter_pass,
                                                        write_qa_report)
        # the filter again over every video's scenes, for the report
        scenes = []
        for vid in video_ids:
            kp_path = work / "keypoints" / f"{vid}.npz"
            if not kp_path.exists():
                continue
            frames, _ = _frames(kp_path)
            for (s, e) in runners.scene_detect(
                    str(work / "videos" / f"{vid}.mp4"), str(work)):
                if frames[s:e]:
                    scenes.append(frames[s:e])
        decisions = run_filter_pass(scenes, fps=fps,
                                    min_shoulder_px=min_shoulder_px)
        out = write_qa_report(scenes, decisions,
                              Path(out_dir) / "qa_report.html")
        result["qa_report"] = str(out)
    return result
