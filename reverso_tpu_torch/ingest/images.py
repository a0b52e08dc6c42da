"""Host-side image ingest: folder scanning, loading, preprocessing, batching.

Mirrors the reference's folder scan semantics (extensions list, optional
recursive walk — reference core_system.py:492-503) but replaces its
serial PIL-per-image loop with a threaded loader that keeps preprocessed
batches ready while the TPU embeds the previous one.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
from PIL import Image

from ..config import IMAGE_EXTENSIONS
from ..models.pe import IMAGE_MEAN, IMAGE_STD


def scan_images(folder: str, *, include_subfolders: bool = False,
                extensions: Sequence[str] = IMAGE_EXTENSIONS) -> list[str]:
    """List image files (reference core_system.py:494-503). Sorted for
    deterministic ingest order."""
    exts = tuple(e.lower() for e in extensions)
    files: list[str] = []
    if include_subfolders:
        for root, _, names in os.walk(folder):
            for name in names:
                if name.lower().endswith(exts):
                    files.append(os.path.join(root, name))
    else:
        if not os.path.isdir(folder):
            return []
        for name in os.listdir(folder):
            p = os.path.join(folder, name)
            # a DIRECTORY named 'vacation.jpg' would otherwise surface
            # as a per-image decode failure in the build transcript
            if name.lower().endswith(exts) and os.path.isfile(p):
                files.append(p)
    return sorted(files)


def preprocess_pil(im: Image.Image, size: int, *,
                   mode: str = "resize_square") -> np.ndarray:
    """PIL -> normalized float32 [size, size, 3].

    "resize_square" resizes directly to (size, size) (PE transform family,
    reference core_system.py:200); "resize_crop" is the CLIP-style shortest
    -side resize + center crop.
    """
    if mode == "resize_square":
        im = im.resize((size, size), Image.Resampling.BICUBIC)
    elif mode == "resize_crop":
        w, h = im.size
        scale = size / min(w, h)
        im = im.resize((round(w * scale), round(h * scale)),
                       Image.Resampling.BICUBIC)
        w, h = im.size
        left, top = (w - size) // 2, (h - size) // 2
        im = im.crop((left, top, left + size, top + size))
    else:
        raise ValueError(mode)
    return normalize_u8(np.asarray(im, np.uint8))


# Folded (x/255 - mean)/std into one scale + one bias pass (fewer
# float temporaries; same f32 math to the ulp as multiply-by-inverse
# is NOT used — the fold keeps the exact reference constants).
_NORM_SCALE = (1.0 / (255.0 * np.asarray(IMAGE_STD, np.float32))).astype(np.float32)
_NORM_BIAS = (-np.asarray(IMAGE_MEAN, np.float32)
              / np.asarray(IMAGE_STD, np.float32)).astype(np.float32)


def normalize_u8(x: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] -> normalized float32 (PE transform constants)."""
    out = x.astype(np.float32)
    out *= _NORM_SCALE
    out += _NORM_BIAS
    return out


def _preprocess_cv2(path: str, size: int, *, keep_original: bool,
                    mode: str = "resize_square"):
    """OpenCV decode + resize: ~2-4x faster per core than PIL.

    When the original isn't needed and the source is comfortably larger
    than `size`, decode at 1/2 DCT scale (IMREAD_REDUCED_COLOR_2).
    Implements the same geometry modes as `preprocess_pil` (the two
    backends must agree on WHAT pixels feed the model even though the
    resamplers differ numerically); unknown modes raise rather than
    silently squashing. Returns (pixels, (w, h), original_or_None).
    """
    import cv2

    if mode not in ("resize_square", "resize_crop"):
        raise ValueError(mode)

    a = None
    w = h = None
    if not keep_original:
        # Peek dimensions from the header only (lazy PIL open) to decide
        # whether the reduced decode still lands >= size.
        try:
            with Image.open(path) as im:
                w, h = im.size
                fmt = im.format
        except Exception:
            fmt, w, h = None, None, None
        if fmt == "JPEG" and w is not None and min(w, h) >= 2 * size:
            # IGNORE_ORIENTATION: OpenCV auto-applies EXIF rotation
            # since 3.4.1, PIL's open+convert does NOT — the backends
            # must feed the model the same pixels, and the (w, h)
            # metadata read from the header above is unrotated
            a = cv2.imread(path, cv2.IMREAD_REDUCED_COLOR_2
                           | cv2.IMREAD_IGNORE_ORIENTATION)
    if a is None:
        a = cv2.imread(path, cv2.IMREAD_COLOR
                       | cv2.IMREAD_IGNORE_ORIENTATION)
    if a is None:
        raise OSError(f"cv2 failed to decode {path}")
    if w is None:
        h, w = a.shape[:2]
    rgb = cv2.cvtColor(a, cv2.COLOR_BGR2RGB)
    orig = rgb if keep_original else None
    if mode == "resize_crop":
        # shortest-side resize + center crop, same arithmetic as
        # preprocess_pil (rounding included) on the DECODED dims
        dh, dw = rgb.shape[:2]
        scale = size / min(dw, dh)
        nw, nh = round(dw * scale), round(dh * scale)
        r = cv2.resize(rgb, (nw, nh), interpolation=cv2.INTER_CUBIC)
        left, top = (nw - size) // 2, (nh - size) // 2
        resized = r[top:top + size, left:left + size]
    else:
        resized = cv2.resize(rgb, (size, size),
                             interpolation=cv2.INTER_CUBIC)
    return normalize_u8(resized), (int(w), int(h)), orig


@dataclass
class LoadedBatch:
    paths: list[str]            # successfully loaded files
    pixels: np.ndarray          # [B, size, size, 3] float32
    sizes: list[tuple[int, int]]  # original (width, height) per image
    failed: list[tuple[str, str]]  # (path, error) for unreadable files
    # original-resolution uint8 RGB arrays, kept only when the consumer
    # asked for them (region mode: the detector must see the ORIGINAL
    # image and report bboxes in original pixels, matching the reference
    # payload semantics — core_system.py:253-266,413-418)
    originals: Optional[list[np.ndarray]] = None


def iter_batches(paths: Sequence[str], size: int, batch_size: int, *,
                 mode: str = "resize_square", workers: int = 8,
                 prefetch: int = 2, keep_originals: bool = False,
                 backend: str = "pil") -> Iterator[LoadedBatch]:
    """Yield preprocessed batches, loading ahead in a thread pool so the
    accelerator never waits on image decode.

    `backend` selects the host decode/resize path (IngestConfig.
    decode_backend): "pil" (reference transform; JPEG draft decode when
    originals aren't kept) or "cv2" (fastest per core). Detection needs
    original-resolution pixels, so `keep_originals=True` always decodes
    at full resolution in either backend.
    """
    if backend not in ("pil", "cv2"):
        raise ValueError(f"unknown decode backend {backend!r}")

    def load_one(path: str):
        try:
            if backend == "cv2":
                px, wh, orig = _preprocess_cv2(
                    path, size, keep_original=keep_originals, mode=mode)
                return path, px, wh, orig, None
            # Original (width, height) is read BEFORE any draft
            # reduction shrinks im.size — it feeds bbox metadata.
            with Image.open(path) as im0:
                wh = im0.size
                if not keep_originals:
                    im0.draft("RGB", (size, size))
                im = im0.convert("RGB")
            orig = np.asarray(im, np.uint8) if keep_originals else None
            return (path, preprocess_pil(im, size, mode=mode), wh,
                    orig, None)
        except Exception as e:  # per-file fault tolerance
            return path, None, None, None, f"{type(e).__name__}: {e}"

    chunks = [list(paths[i:i + batch_size])
              for i in range(0, len(paths), batch_size)]

    def assemble(futs):
        ok_paths, pixels, sizes, originals, failed = [], [], [], [], []
        for f in futs:
            path, px, sz, orig, err = f.result()
            if err is None:
                ok_paths.append(path)
                pixels.append(px)
                sizes.append(sz)
                originals.append(orig)
            else:
                failed.append((path, err))
        arr = (np.stack(pixels) if pixels
               else np.zeros((0, size, size, 3), np.float32))
        return LoadedBatch(ok_paths, arr, sizes, failed,
                           originals if keep_originals else None)

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        # a chunk is its list of per-FILE futures — never a pool task
        # that blocks on other pool tasks (the old chunk-level task
        # called ex.map inside the same pool and DEADLOCKED whenever
        # workers <= prefetch: every worker sat in a load_chunk waiting
        # on load_one futures queued behind it)
        pending: list[list[cf.Future]] = []
        idx = 0
        while idx < len(chunks) and len(pending) < prefetch:
            pending.append([ex.submit(load_one, p) for p in chunks[idx]])
            idx += 1
        while pending:
            batch = assemble(pending.pop(0))
            if idx < len(chunks):
                pending.append([ex.submit(load_one, p)
                                for p in chunks[idx]])
                idx += 1
            yield batch
