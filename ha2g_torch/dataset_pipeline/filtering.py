"""Scene filtering of the dataset construction (the port of
ha2g_tpu/dataset_pipeline/filtering.py; reference
dataset_script/script/clip_filter.py and main_speaker_selector.py), on
plain keypoint arrays:

* ``select_main_speaker``: the person with the highest mean upper-body
  confidence in the first frame with people, then tracked through the
  scene by nearest neighbour with a tracking-failure distance gate
  (main_speaker_selector.py:26-99);
* ``ClipFilter``: rejects scenes that are too short, crowded, facing
  away, missing joints, sideways or too small (clip_filter.py:18-188).
  The still-picture check (video frames) and the ExPose reprojection
  bounds check are optional hooks.

Keypoints: OpenPose BODY_25-style upper body, (x, y, confidence) a point;
joint 0 nose, 1 neck, 2 right shoulder, 5 left shoulder.  A frame is an
array (n_people, n_points, 3); a scene is a list of frames.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

UPPER_BODY = tuple(range(8))  # nose .. left wrist


def _mean_confidence(person: np.ndarray) -> float:
    pts = person[list(UPPER_BODY)]
    ok = (pts[:, 0] > 0) & (pts[:, 1] > 0) & (pts[:, 2] > 0)
    return float(pts[ok, 2].mean()) if ok.any() else 0.0


def _closest_person(frame: np.ndarray, ref: np.ndarray
                    ) -> Optional[np.ndarray]:
    """Nearest neighbour of ``ref`` in the frame, None when it is farther
    than the reference's failure gate (main_speaker_selector.py:74-99)."""
    best, best_diff = None, np.inf
    for person in frame:
        both = (person[list(UPPER_BODY), :2] > 0) & \
            (ref[list(UPPER_BODY), :2] > 0)
        n = both.sum()
        diff = np.abs(person[list(UPPER_BODY), :2] -
                      ref[list(UPPER_BODY), :2])[both].sum() / n if n else 0.0
        if diff < best_diff:
            best_diff, best = diff, person
    base = max(abs(ref[0, 1] - ref[1, 1]) * 3, abs(ref[2, 0] - ref[5, 0]) * 2)
    if best is not None and best_diff > base:
        return None  # tracking failed
    return best


def select_main_speaker(scene: Sequence[np.ndarray]
                        ) -> list[Optional[np.ndarray]]:
    """A frame each: the tracked main speaker's (n_points, 3) keypoints or
    None."""
    tracked: list[Optional[np.ndarray]] = []
    ref: Optional[np.ndarray] = None
    for frame in scene:
        if ref is None and len(frame):
            confs = [_mean_confidence(p) for p in frame]
            if confs:
                ref = frame[int(np.argmax(confs))]
        person = _closest_person(frame, ref) if ref is not None and \
            len(frame) else None
        tracked.append(person)
        if person is not None:
            ref = person
    return tracked


class ClipFilter:
    """The scene-level quality gate (clip_filter.py:18-188).
    ``is_correct_clip`` runs the checks in order and leaves "PASS" or the
    first failing check's reason in ``message``."""

    def __init__(self, scene: Sequence[np.ndarray],
                 speakers: Sequence[Optional[np.ndarray]],
                 fps: float = 25.0, min_shoulder_px: float = 100.0,
                 picture_check: Optional[Callable[[], bool]] = None,
                 bounds_check: Optional[Callable[[int], bool]] = None):
        self.scene = scene
        self.speakers = speakers
        self.n = max(len(scene), 1)
        self.fps = fps
        self.min_shoulder_px = min_shoulder_px
        self.picture_check = picture_check
        self.bounds_check = bounds_check
        self.message = ""

    def _bad_ratio(self, pred) -> float:
        bad = 0
        for i, s in enumerate(self.speakers):
            if s is None or pred(i, s):
                bad += 1
        return bad / self.n

    def is_too_short(self) -> bool:
        return self.n < self.fps * 3  # clip_filter.py:126-128

    def is_many_people(self) -> bool:
        counts = [len(f) for f in self.scene]
        return len(counts) > 0 and float(np.mean(counts)) > 5

    def is_back(self) -> bool:
        # right shoulder x > left shoulder x: facing away
        return self._bad_ratio(lambda i, s: s[2, 0] > s[5, 0]) > 0.3

    def is_missing_joints(self) -> bool:
        def pred(i, s):
            if any(s[j, 0] == 0 for j in UPPER_BODY):
                return True
            if self.bounds_check is not None:
                return not self.bounds_check(i)
            return False
        return self._bad_ratio(pred) > 0.5

    def is_sideways(self) -> bool:
        def pred(i, s):
            lo, hi = min(s[2, 0], s[5, 0]), max(s[2, 0], s[5, 0])
            return s[0, 0] < lo or s[0, 0] > hi
        return self._bad_ratio(pred) > 0.5

    def is_small(self) -> bool:
        def pred(i, s):
            return np.hypot(s[2, 0] - s[5, 0], s[2, 1] - s[5, 1]) < \
                self.min_shoulder_px
        return self._bad_ratio(pred) > 0.5

    def is_picture(self) -> bool:
        return self.picture_check() if self.picture_check else False

    def is_correct_clip(self) -> bool:
        checks = [
            (self.is_too_short, "too short"),
            (self.is_many_people, "too many people"),
            (self.is_back, "looking behind"),
            (self.is_missing_joints, "too many missing joints"),
            (self.is_sideways, "looking sideways"),
            (self.is_small, "too small"),
            (self.is_picture, "still picture"),
        ]
        for check, msg in checks:
            if check():
                self.message = msg
                return False
        self.message = "PASS"
        return True
