"""Blur-based keyframe selection (copy of `intrinsic3d_tpu/keyframes.py`).

Re-design of ``nv::KeyframeSelection`` (``libintrinsic3d/src/keyframe_selection.cpp``):
the frames' Crete blur scores (`image.blur.blur_scores_batch`) pick the
best-scoring frame per fixed-size window; ``keyframes.txt`` keeps the
reference's format (first line: window size; then `score is_keyframe` per
frame).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class KeyframeSelection:
    window_size: int = 20
    frame_scores: List[float] = dataclasses.field(default_factory=list)
    is_keyframe: List[bool] = dataclasses.field(default_factory=list)

    def add_scores(self, scores: Sequence[float]) -> None:
        self.frame_scores.extend(float(s) for s in scores)

    def select(self) -> None:
        """Best-in-window argmax selection (``keyframe_selection.cpp:73-106``)."""
        n = len(self.frame_scores)
        self.is_keyframe = [False] * n
        scores = np.asarray(self.frame_scores)
        for beg in range(0, n, self.window_size):
            end = min(beg + self.window_size, n)
            # the reference keeps id_max = window start if all scores are <= 0
            win = scores[beg:end]
            id_max = beg + int(np.argmax(win)) if np.any(win > 0.0) else beg
            self.is_keyframe[id_max] = True

    def keyframe_ids(self) -> List[int]:
        return [i for i, k in enumerate(self.is_keyframe) if k]

    def count(self) -> int:
        return sum(self.is_keyframe)

    # -- reference-compatible text format ---------------------------------

    def save(self, filename: str) -> None:
        """`window_size` then `score is_kf` lines (``keyframe_selection.cpp:182-207``)."""
        with open(filename, "w") as f:
            f.write(f"{self.window_size}\n")
            for score, kf in zip(self.frame_scores, self.is_keyframe):
                f.write(f"{score:.6f} {int(kf)}\n")

    @classmethod
    def load(cls, filename: str) -> "KeyframeSelection":
        with open(filename) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        sel = cls(window_size=int(lines[0]))
        for ln in lines[1:]:
            parts = ln.split()
            sel.frame_scores.append(float(parts[0]))
            sel.is_keyframe.append(bool(int(parts[1])))
        return sel
