"""Visualization: mask contours and search-result rendering.

Host-side (OpenCV/PIL) — rebuilds the reference's `visualize_detections`
(reference core_system.py:719-757: green contour + thick line for the
selected region, red for the rest, numbered labels at mask centroids)
and the search-result thumbnail overlay (core_system.py:684-714).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image, ImageDraw, ImageFont

try:
    import cv2
except ImportError:          # pragma: no cover
    cv2 = None

from .detect.regions import Regions


def to_rgb_array(image) -> np.ndarray:
    """np/PIL/path -> [H, W, 3] uint8 RGB (reference duck typing,
    core_system.py:726-731)."""
    if isinstance(image, np.ndarray):
        arr = image
    elif isinstance(image, str):
        with Image.open(image) as im:
            arr = np.array(im.convert("RGB"))
    else:
        arr = np.array(image.convert("RGB"))
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    elif arr.shape[2] == 4:
        arr = arr[:, :, :3]
    if np.issubdtype(arr.dtype, np.floating):
        # DTYPE convention, same as preprocess_images: float pixels are
        # 0-1 (matplotlib/ToTensor), integers 0-255. A content
        # heuristic (max() <= 1.0 -> x255) would amplify a near-black
        # 0-255-float frame to noise — and this array feeds the
        # DETECTOR (engine.detect_regions), not just drawings.
        arr = np.clip(arr * 255.0, 0, 255)
    return arr.astype(np.uint8)


def visualize_detections(image, regions: Optional[Regions],
                         selected_region_index: Optional[int] = None) -> Image.Image:
    """Draw region contours; selection highlighted green/thick."""
    arr = to_rgb_array(image)
    if regions is None or regions.masks is None or len(regions) == 0 or cv2 is None:
        return Image.fromarray(arr)
    overlay = arr.copy()
    for i, mask in enumerate(regions.masks):
        selected = i == selected_region_index
        color = (0, 255, 0) if selected else (255, 0, 0)
        width = 3 if selected else 1
        binary = (mask > 0.5).astype(np.uint8)
        contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(overlay, contours, -1, color, width)
        ys, xs = np.where(binary)
        if ys.size:
            cx, cy = int(xs.mean()), int(ys.mean())
            cv2.putText(overlay, str(i + 1), (cx, cy),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                        (0, 0, 0) if selected else color, 2)
    return Image.fromarray(overlay)


def render_result_thumbnail(image_path: str, score: float,
                            max_size: int = 400) -> Optional[Image.Image]:
    """Load a hit's source image with a score overlay, thumbnailed
    (reference core_system.py:692-704)."""
    try:
        with Image.open(image_path) as im:
            img = im.convert("RGB").copy()
    except Exception:
        return None
    draw = ImageDraw.Draw(img)
    font_size = max(15, int(min(img.height, img.width) * 0.05))
    try:
        font = ImageFont.truetype("DejaVuSans.ttf", font_size)
    except IOError:
        font = ImageFont.load_default()
    text = f"Score: {score:.3f}"
    tb = draw.textbbox((5, 5), text, font=font)
    draw.rectangle([tb[0] - 2, tb[1] - 2, tb[2] + 2, tb[3] + 2], fill="black")
    draw.text((5, 5), text, fill="white", font=font)
    img.thumbnail((max_size, max_size), Image.Resampling.LANCZOS)
    return img
