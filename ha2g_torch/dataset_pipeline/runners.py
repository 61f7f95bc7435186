"""The external-tool steps of the dataset construction (the port of
ha2g_tpu/dataset_pipeline/runners.py; reference dataset_script/script/:
download_video.py, run_mp3.py, run_openpose.py, run_expose.py,
run_scenedetect.py, run_gentle.py).

None of the tools (yt-dlp, ffmpeg, OpenPose, ExPose, PySceneDetect,
gentle) ships with the port.  Each step returns its output artifact when
it exists already (the reference's RESUME_VID / SKIP_EXISTING pattern,
run_openpose.py:33-34), and otherwise raises ``StepUnavailable`` when its
tool is missing.  The order (dataset_script/README.md:37-88):

  1. download        video + subtitles      -> <work>/videos/<vid>.mp4/.vtt
  2. extract_audio   16 kHz mono wav         -> <work>/audio/<vid>.wav
  3. pose_estimation OpenPose / ExPose output -> <work>/keypoints/<vid>.npz
  4. scene_detect    content-change scenes   -> <work>/scenes/<vid>.csv
  5. align           word timings (gentle)   -> <work>/align/<vid>.json
  6. filter + assemble (this package)        -> clip storage splits
"""

from __future__ import annotations

import csv
import json
import pickle
import shutil
import subprocess
from pathlib import Path

import numpy as np


class StepUnavailable(RuntimeError):
    pass


def _need(binary: str, hint: str) -> str:
    path = shutil.which(binary)
    if path is None:
        raise StepUnavailable(f"`{binary}` not found; {hint}")
    return path


def download(vid: str, work_dir: str, tool: str = "yt-dlp") -> Path:
    """The YouTube video and its auto subtitles (download_video.py)."""
    out = Path(work_dir) / "videos"
    out.mkdir(parents=True, exist_ok=True)
    target = out / f"{vid}.mp4"
    if target.exists():
        return target
    exe = _need(tool, "install yt-dlp/youtube-dl to fetch source videos")
    subprocess.run([exe, "-f", "mp4", "--write-auto-sub", "--sub-lang", "en",
                    "-o", str(target), f"https://youtu.be/{vid}"],
                   check=True)
    return target


def extract_audio(video_path: str, work_dir: str) -> Path:
    """ffmpeg -> 16 kHz mono wav (run_mp3.py:40)."""
    out = Path(work_dir) / "audio"
    out.mkdir(parents=True, exist_ok=True)
    target = out / (Path(video_path).stem + ".wav")
    if target.exists():
        return target
    exe = _need("ffmpeg", "audio extraction needs ffmpeg")
    subprocess.run([exe, "-loglevel", "panic", "-y", "-i", video_path,
                    "-ac", "1", "-ar", "16000", str(target)], check=True)
    return target


def scene_detect(video_path: str, work_dir: str,
                 threshold: float = 27.0) -> list[tuple[int, int]]:
    """PySceneDetect's content detector -> [(start_frame, end_frame)]
    (run_scenedetect.py:18-24), kept as a csv of two columns."""
    out = Path(work_dir) / "scenes"
    out.mkdir(parents=True, exist_ok=True)
    target = out / (Path(video_path).stem + ".csv")
    if not target.exists():
        try:
            from scenedetect import ContentDetector, SceneManager, open_video
        except ImportError as e:
            raise StepUnavailable(
                "scene detection needs the scenedetect package") from e
        video = open_video(video_path)
        mgr = SceneManager()
        mgr.add_detector(ContentDetector(threshold=threshold))
        mgr.detect_scenes(video)
        with open(target, "w", newline="") as f:
            writer = csv.writer(f)
            for s, e in mgr.get_scene_list():
                writer.writerow([s.get_frames(), e.get_frames()])
    with open(target) as f:
        return [(int(r[0]), int(r[1])) for r in csv.reader(f) if r]


def align(audio_path: str, transcript: str, work_dir: str) -> list:
    """Word timings [(word, start, end)] from a forced alignment kept as
    <work>/align/<vid>.json (run_gentle.py:33).  The port does not drive
    gentle itself: without that file the step is unavailable (in the JAX
    package it needs the gentle package, which neither machine has)."""
    out = Path(work_dir) / "align"
    out.mkdir(parents=True, exist_ok=True)
    target = out / (Path(audio_path).stem + ".json")
    if target.exists():
        return [tuple(w) for w in json.loads(target.read_text())]
    raise StepUnavailable(f"no forced alignment at {target} (gentle is not "
                          "driven by the port)")


# the SMPL-X joint rows the reference keeps as the 23-joint upper body
# (make_ted_dataset.py:171-175: joints[9], joints[12], joints[16:22],
# joints[55:60], joints[66:76])
_EXPOSE_UPPER_BODY = (9, 12, 16, 17, 18, 19, 20, 21,
                      55, 56, 57, 58, 59) + tuple(range(66, 76))


def openpose_json_to_arrays(json_dir: str) -> list:
    """An OpenPose JSON output directory -> a (n_people, n_points, 3)
    array a frame.

    Each frame file's ``people`` (run_openpose.py:41-54), each person's
    ``pose_keypoints_2d`` (or the pre-1.3 ``pose_keypoints``) flat [x, y,
    conf, ...] list (data_utils.py:303-309).  Frames are the directory's
    sorted ``*.json`` files: OpenPose names them
    <prefix>_%012d_keypoints.json, so name order is frame order.
    """
    frames = []
    for path in sorted(Path(json_dir).glob("*.json")):
        people = json.loads(path.read_text()).get("people", [])
        persons = []
        for person in people:
            flat = person.get("pose_keypoints_2d",
                              person.get("pose_keypoints"))
            if flat is None:
                continue
            persons.append(np.asarray(flat, np.float32).reshape(-1, 3))
        frames.append(np.stack(persons) if persons
                      else np.zeros((0, 25, 3), np.float32))
    return frames


def expose_to_skeletons(expose_dir: str, n_frames: int) -> np.ndarray:
    """An ExPose output directory -> (n_frames, 23, 3) upper-body joints.

    ExPose writes a <stem>_params.npz a frame image holding the SMPL-X
    ``joints``; the reference keeps 23 upper-body rows
    (make_ted_dataset.py:171-177) and zeros for frames without an
    estimate.  Pickled dicts (``*_params.pkl``, some ExPose versions) are
    read as well.
    """
    by_frame = {}
    for path in sorted(Path(expose_dir).glob("**/*_params.npz")):
        by_frame[len(by_frame)] = dict(np.load(path, allow_pickle=True))
    if not by_frame:
        for path in sorted(Path(expose_dir).glob("**/*_params.pkl")):
            with open(path, "rb") as f:
                by_frame[len(by_frame)] = pickle.load(f)

    out = np.zeros((n_frames, len(_EXPOSE_UPPER_BODY), 3), np.float32)
    for i in range(min(n_frames, len(by_frame))):
        joints = np.asarray(by_frame[i]["joints"], np.float32)
        if joints.ndim == 3:            # (1, n_joints, 3): a batch axis
            joints = joints[0]
        if joints.shape[0] >= 76:
            out[i] = joints[list(_EXPOSE_UPPER_BODY)]
    return out


def pose_estimation(video_path: str, work_dir: str,
                    openpose_json_dir: str | None = None,
                    expose_dir: str | None = None) -> Path:
    """The OpenPose / ExPose adapter.  The estimators are outside CUDA
    programs (run_openpose.py:28, run_expose.py:16); their outputs on disk
    are read:

    * OpenPose's JSON a frame (``openpose_json_dir``, by default
      ``<work>/openpose/<vid>/``) -> ``keypoints_2d``;
    * ExPose's parameters a frame (``expose_dir``, by default
      ``<work>/expose/<vid>/``, optional) -> ``skeletons_3d`` (F, 23, 3),
      zeros without them (2-D only videos, e.g. TED Gesture).

    Writes <work>/keypoints/<vid>.npz with ``keypoints_2d`` (an object
    array: a (n_people, n_points, 3) array a frame) and ``skeletons_3d``,
    what ``select_main_speaker`` and ``assemble_clips`` read.  Any other
    estimator works by writing the same file."""
    vid = Path(video_path).stem
    target = Path(work_dir) / "keypoints" / f"{vid}.npz"
    if target.exists():
        return target

    if openpose_json_dir is None:
        candidate = Path(work_dir) / "openpose" / vid
        openpose_json_dir = str(candidate) if candidate.is_dir() else None
    if openpose_json_dir is None:
        raise StepUnavailable(
            "pose estimation requires an external estimator (OpenPose + "
            f"ExPose in the reference); run OpenPose with --write_json into "
            f"{Path(work_dir) / 'openpose' / vid} or place a converted "
            f"output at {target}")

    frames = openpose_json_to_arrays(openpose_json_dir)
    if expose_dir is None:
        candidate = Path(work_dir) / "expose" / vid
        expose_dir = str(candidate) if candidate.is_dir() else None
    skel_3d = (expose_to_skeletons(expose_dir, len(frames))
               if expose_dir is not None
               else np.zeros((len(frames), len(_EXPOSE_UPPER_BODY), 3),
                             np.float32))

    target.parent.mkdir(parents=True, exist_ok=True)
    kp = np.empty(len(frames), dtype=object)
    for i, f in enumerate(frames):
        kp[i] = f
    np.savez_compressed(target, keypoints_2d=kp, skeletons_3d=skel_3d)
    return target
