"""Detection data structures and the detector interface.

`Regions` replaces the reference's `supervision.Detections` container
(reference core_system.py:36,303-308) with a plain numpy struct. The
detector interface is prompt-conditioned open-vocabulary detection +
segmentation (the reference's GroundedSAM, core_system.py:205-235);
`StubDetector` provides deterministic boxes/masks so integration tests
and CI never need model weights (SURVEY.md §4 item 5).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, Sequence

import numpy as np

from ..config import DetectorConfig


def parse_prompts(text_prompt: Optional[str], default: str = "object") -> list[str]:
    """Period-separated prompt parsing with fallback
    (reference core_system.py:209-213)."""
    prompts: list[str] = []
    if text_prompt:
        prompts = [p.strip() for p in text_prompt.split(".") if p.strip()]
    if not prompts:
        prompts = [default]
    return prompts


@dataclass
class Regions:
    """Per-image detection output (dynamic length; padding to MAX_REGIONS
    happens at the device boundary)."""
    boxes: np.ndarray                  # [N, 4] xyxy pixels, float32
    confidences: np.ndarray            # [N] float32
    class_ids: np.ndarray              # [N] int32
    class_names: list[str]            # ontology (prompt list)
    masks: Optional[np.ndarray] = None  # [N, H, W] bool, or None

    def __len__(self) -> int:
        return int(self.boxes.shape[0])

    @staticmethod
    def empty(height: int, width: int, class_names: Sequence[str] = ("object",)) -> "Regions":
        return Regions(
            boxes=np.zeros((0, 4), np.float32),
            confidences=np.zeros((0,), np.float32),
            class_ids=np.zeros((0,), np.int32),
            class_names=list(class_names),
            masks=np.zeros((0, height, width), bool),
        )

    def class_name(self, i: int) -> str:
        cid = int(self.class_ids[i])
        if 0 <= cid < len(self.class_names):
            return self.class_names[cid]
        return "object"   # reference fallback, core_system.py:394


class BaseDetector(Protocol):
    """Prompt-conditioned detector + segmenter."""

    def detect(self, image: np.ndarray, prompts: Sequence[str]) -> Regions:
        """image: [H, W, 3] uint8 RGB. Returns Regions with masks."""
        ...


class StubDetector:
    """Deterministic fake detector for tests and CI.

    Emits `boxes_per_prompt` square regions per prompt, tiled across the
    image, with rectangular masks. Confidences descend from 0.9.
    """

    def __init__(self, cfg: DetectorConfig | None = None,
                 boxes_per_prompt: int = 2):
        self.cfg = cfg or DetectorConfig()
        self.boxes_per_prompt = boxes_per_prompt

    def detect(self, image: np.ndarray, prompts: Sequence[str]) -> Regions:
        h, w = image.shape[:2]
        boxes, confs, cids, masks = [], [], [], []
        n_total = len(prompts) * self.boxes_per_prompt
        i = 0
        for cid, _ in enumerate(prompts):
            for j in range(self.boxes_per_prompt):
                frac = (i + 1) / (n_total + 1)
                size = max(4, int(min(h, w) * 0.3))
                x0 = int((w - size) * frac)
                y0 = int((h - size) * frac)
                box = [x0, y0, x0 + size, y0 + size]
                m = np.zeros((h, w), bool)
                m[y0:y0 + size, x0:x0 + size] = True
                boxes.append(box)
                confs.append(0.9 - 0.1 * j)
                cids.append(cid)
                masks.append(m)
                i += 1
        return Regions(
            boxes=np.asarray(boxes, np.float32),
            confidences=np.asarray(confs, np.float32),
            class_ids=np.asarray(cids, np.int32),
            class_names=list(prompts),
            masks=np.stack(masks) if masks else np.zeros((0, h, w), bool),
        )
