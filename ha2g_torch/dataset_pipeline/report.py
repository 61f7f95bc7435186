"""The dataset-construction QA report (the port of
ha2g_tpu/dataset_pipeline/report.py: the reference's review GUI, made
headless).

The reference ships an OpenCV tool to step through the filter's decisions
scene by scene over the video with the tracked skeleton drawn on it
(dataset_script/script/review_filtered_clips.py:34-383).  This writes the
same review as one HTML file: a verdict a scene, the reasons' counts, and
skeleton contact sheets of a sample of passed and rejected scenes, PNGs
inlined as data URIs.  The JAX package draws the sheets with matplotlib;
the port rasterises them itself (``utils/image.py``), so their pixels
differ, not what they show: everyone in the frame as grey dots, the
tracked speaker's bones in blue and joints in red.

``run_filter_pass`` tracks the main speaker and runs ``ClipFilter`` over
each scene (the logic of dataset_script/script/run_filtering.py), keeping
every decision for the report.
"""

from __future__ import annotations

import base64
import html
from collections import Counter
from pathlib import Path
from typing import Sequence

import numpy as np

from ha2g_torch.dataset_pipeline.filtering import (ClipFilter,
                                                   select_main_speaker)
from ha2g_torch.utils.image import TAB10, draw_dots, draw_line, png_bytes, rgb

# the OpenPose BODY_25 upper-body bones the reference review tool draws
_BONES = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7)]
# a contact sheet's panel: 3 inches at 72 dpi, as the JAX package's figure
PANEL_PX = 216
_GREY, _FRAME = (187, 187, 187), (220, 220, 220)


def run_filter_pass(scenes: Sequence[Sequence[np.ndarray]],
                    fps: float = 25.0,
                    min_shoulder_px: float = 100.0) -> list[dict]:
    """Track and filter each scene; -> a decision record a scene:
    {index, verdict ('PASS' or the reason), passed, n_frames, speakers}."""
    decisions = []
    for i, scene in enumerate(scenes):
        speakers = select_main_speaker(scene)
        f = ClipFilter(scene, speakers, fps=fps,
                       min_shoulder_px=min_shoulder_px)
        ok = f.is_correct_clip()
        decisions.append({
            "index": i, "verdict": f.message if not ok else "PASS",
            "passed": ok, "n_frames": len(scene), "speakers": speakers,
        })
    return decisions


def _panel(frame: np.ndarray, person) -> np.ndarray:
    """One frame's keypoints as a (PANEL_PX, PANEL_PX, 3) raster at an
    equal aspect: the people's points grey, the tracked speaker's bones
    and joints on top."""
    img = np.full((PANEL_PX, PANEL_PX, 3), 255, np.uint8)
    pts = [p[:, :2] for p in frame]
    if person is not None:
        pts.append(person[:, :2])
    xy = np.concatenate(pts) if pts else np.zeros((0, 2), np.float32)
    xy = xy[(xy > 0).all(axis=1)]
    if len(xy):
        lo, hi = xy.min(0), xy.max(0)
        centre = (lo + hi) / 2
        span = max(float((hi - lo).max()), 1.0) * 1.1
        scale = (PANEL_PX - 8) / span

        def px(p):
            return ((p[..., 0] - centre[0]) * scale + PANEL_PX / 2,
                    (p[..., 1] - centre[1]) * scale + PANEL_PX / 2)

        for other in frame:
            draw_dots(img, *px(other[:, :2]), _GREY, radius=1)
        if person is not None:
            p = person[:, :2]
            x, y = px(p)
            for a, b in _BONES:
                if p[a].all() and p[b].all():
                    draw_line(img, (x[a], y[a]), (x[b], y[b]),
                              rgb(TAB10[0]), width=2)
            draw_dots(img, x, y, rgb(TAB10[3]), radius=2)
    img[[0, -1], :] = _FRAME
    img[:, [0, -1]] = _FRAME
    return img


def _sheet_frames(scene, n_cols: int = 4) -> np.ndarray:
    """The evenly spaced frames a contact sheet shows."""
    return np.linspace(0, len(scene) - 1, min(n_cols, len(scene)),
                       dtype=int)


def _overlay_png(scene, speakers) -> bytes:
    """A contact sheet: the tracked-speaker overlay of ``_sheet_frames``
    side by side (the reference tool's skeleton drawing, in batch)."""
    return png_bytes(np.concatenate(
        [_panel(scene[i], speakers[i]) for i in _sheet_frames(scene)],
        axis=1))


def write_qa_report(scenes: Sequence[Sequence[np.ndarray]],
                    decisions: Sequence[dict], out_path: str | Path,
                    max_overlays: int = 6) -> Path:
    """The decisions of ``run_filter_pass`` as one HTML file: the reasons'
    counts and shares, contact sheets of up to ``max_overlays`` scenes
    (half passed, the rest rejected; the caption says which frames) and
    the verdict of every scene."""
    out_path = Path(out_path)
    counts = Counter(d["verdict"] for d in decisions)
    n = max(len(decisions), 1)

    rows = "\n".join(
        f"<tr class={'pass' if d['passed'] else 'fail'}>"
        f"<td>{d['index']}</td><td>{d['n_frames']}</td>"
        f"<td>{html.escape(d['verdict'])}</td></tr>"
        for d in decisions)
    stats = "\n".join(
        f"<tr><td>{html.escape(k)}</td><td>{v}</td>"
        f"<td>{100 * v / n:.1f}%</td></tr>"
        for k, v in counts.most_common())

    imgs = []
    passed = [d for d in decisions if d["passed"]]
    failed = [d for d in decisions if not d["passed"]]
    for d in (passed[:max_overlays // 2] +
              failed[:max_overlays - len(passed[:max_overlays // 2])]):
        scene = scenes[d["index"]]
        png = _overlay_png(scene, d["speakers"])
        frames = ", ".join(map(str, _sheet_frames(scene)))
        imgs.append(f"<p>scene {d['index']}: {html.escape(d['verdict'])} "
                    f"(frames {frames})</p>"
                    f'<img src="data:image/png;base64,'
                    f'{base64.b64encode(png).decode()}"/>')

    out_path.write_text(f"""<!doctype html><meta charset="utf-8">
<title>dataset QA report</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; margin: 1em 0; }}
 td, th {{ border: 1px solid #ccc; padding: 2px 10px; }}
 tr.pass td {{ background: #eaffea; }}
 tr.fail td {{ background: #ffecec; }}
 img {{ display: block; margin: 8px 0; max-width: 100%; }}
</style>
<h1>Dataset QA report</h1>
<p>{len(decisions)} scenes; {sum(d['passed'] for d in decisions)} passed
({100 * sum(d['passed'] for d in decisions) / n:.1f}%).</p>
<h2>Filter reasons</h2>
<table><tr><th>verdict</th><th>scenes</th><th>share</th></tr>{stats}</table>
<h2>Skeleton overlays</h2>
{''.join(imgs)}
<h2>Per-scene decisions</h2>
<table><tr><th>scene</th><th>frames</th><th>verdict</th></tr>{rows}</table>
""")
    return out_path
