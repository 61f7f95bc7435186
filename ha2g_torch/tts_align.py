"""Word timings for ``cli from-text`` (JAX tts_align.py:80).

Only the uniform alignment is ported: Google TTS and gentle forced
alignment need the network or outside tools, so ``from-text`` takes a WAV
file and spreads the transcript's words over it.
"""

from __future__ import annotations

import re


def uniform_align(transcript: str, duration_s: float
                  ) -> list[tuple[str, float, float]]:
    """Spread the words evenly over the clip: word i starts at
    (i + 1) * duration / (n + 1) and lasts at most 0.3 s."""
    words = [w for w in re.split(r"\s+", transcript.strip()) if w]
    if not words:
        return []
    step = duration_s / (len(words) + 1)
    return [(w, (i + 1) * step, (i + 1) * step + min(step, 0.3))
            for i, w in enumerate(words)]
