"""Video ingest: scene detection, keyframe extraction, URL downloads.

Rebuilds the reference's `video_processing.py` end to end:

  * scene detection — the reference uses PySceneDetect's ContentDetector
    (HSV frame-delta threshold, video_processing.py:211-218). That
    package isn't a dependency here; `detect_scenes` implements the same
    algorithm directly on OpenCV frames (mean |ΔH|+|ΔS|+|ΔV| / 3 vs
    threshold, min-scene-len guard), with an optional batched scorer on
    the card for long videos (`content_scores_batched`, plain PyTorch: the
    JAX package's was XLA, not a Pallas kernel);
  * scene-based extraction with `frames_per_scene` uniform offsets and
    `{video}_scene{i:03d}_frame{j:03d}.jpg` names
    (video_processing.py:246-280);
  * uniform fallback with `{video}_uniform_{n:03d}.jpg` names
    (video_processing.py:293-359);
  * the two UI-facing pipelines writing `{id}_{MM}m{SS}s.jpg` frames
    (video_processing.py:361-560);
  * URL validation against the platform allowlist
    (video_processing.py:49-80) and yt-dlp downloads, gated on yt-dlp
    being installed (it is optional, exactly as the reference gates it,
    video_processing.py:33-38).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import time
import urllib.parse
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:              # pragma: no cover
    cv2 = None

try:
    import yt_dlp                # optional, like the reference
    YT_DLP_AVAILABLE = True
except ImportError:
    yt_dlp = None
    YT_DLP_AVAILABLE = False

from ..config import SUPPORTED_VIDEO_DOMAINS, VIDEO_EXTENSIONS
from ..utils.logging import StatusLog

JPEG_QUALITY = 95                # reference video_processing.py:275


# ---------------------------------------------------------------------------
# URL validation / download
# ---------------------------------------------------------------------------

def is_supported_video_url(url) -> bool:
    """Platform allowlist check (reference video_processing.py:49-80)."""
    if not url or not isinstance(url, str):
        return False
    try:
        parsed = urllib.parse.urlparse(url.strip())
        domain = parsed.netloc.lower()
        if domain.startswith("www."):
            domain = domain[4:]
        return domain in SUPPORTED_VIDEO_DOMAINS
    except Exception:
        return False


def download_video_from_url(url: str, output_dir: str,
                            max_quality: str = "720p"):
    """yt-dlp download with hash+timestamp filenames
    (reference video_processing.py:82-183).
    Returns (success, message, path)."""
    if not YT_DLP_AVAILABLE:
        return False, "yt-dlp not available. Please install it: pip install yt-dlp", None
    if not is_supported_video_url(url):
        return False, f"Unsupported URL or invalid format: {url}", None
    try:
        os.makedirs(output_dir, exist_ok=True)
        url_hash = hashlib.md5(url.encode()).hexdigest()[:8]
        stamp = int(time.time())
        template = os.path.join(output_dir, f"video_{stamp}_{url_hash}.%(ext)s")
        height = max_quality[:-1] if max_quality.endswith("p") else max_quality
        downloaded: list[str] = []

        def hook(d):
            if d.get("status") == "finished":
                p = d.get("filename")
                if p and os.path.exists(p) and not any(
                        t in os.path.basename(p) for t in (".f", ".part", ".temp")):
                    downloaded.append(p)

        opts = {
            "outtmpl": template,
            "format": f"best[height<={height}]/best",
            "merge_output_format": "mp4",
            "quiet": True,
            "no_warnings": True,
            "restrictfilenames": True,
            "progress_hooks": [hook],
        }
        with yt_dlp.YoutubeDL(opts) as ydl:
            ydl.download([url])
        if not downloaded:
            # fallback: newest video file written in the last 2 minutes
            # (reference video_processing.py:149-161)
            exts = {".mp4", ".avi", ".mov", ".mkv", ".wmv", ".flv", ".webm", ".m4v"}
            for f in os.listdir(output_dir):
                p = os.path.join(output_dir, f)
                if (os.path.splitext(f.lower())[1] in exts and os.path.isfile(p)
                        and os.path.getmtime(p) > time.time() - 120):
                    downloaded.append(p)
        if not downloaded:
            return False, "Download completed but no valid video file was created", None
        downloaded.sort(key=os.path.getmtime, reverse=True)
        path = downloaded[0]
        return True, f"Successfully downloaded video ({os.path.getsize(path)} bytes)", path
    except Exception as e:      # error classification, reference :174-183
        msg = str(e)
        if "Private video" in msg:
            return False, "Video is private or requires authentication", None
        if "Video unavailable" in msg:
            return False, "Video is unavailable or has been removed", None
        if "Unsupported URL" in msg:
            return False, f"URL not supported by yt-dlp: {url}", None
        return False, f"Download failed: {msg}", None


# ---------------------------------------------------------------------------
# Scene detection (ContentDetector-equivalent)
# ---------------------------------------------------------------------------

@dataclass
class VideoInfo:
    fps: float
    frame_count: int

    @property
    def duration(self) -> float:
        return self.frame_count / self.fps if self.fps else 0.0


def content_scores_batched(hsv_frames: np.ndarray, device=None) -> np.ndarray:
    """Batched scorer for a [T, H, W, 3] uint8 HSV stack — the
    device-side variant for long videos (SURVEY.md §2.2 OpenCV row):
    int16 frame deltas, their fp32 mean per channel, summed over the
    channels / 3. Returns [T - 1] fp32 scores on the host. `device=None`
    means CUDA, which raises where there is none."""
    import torch
    from ..models.pe import resolve_device
    x = torch.as_tensor(np.asarray(hsv_frames), device=resolve_device(device))
    return content_scores_tensor(x).cpu().numpy()


def content_scores_tensor(hsv):
    """`content_scores_batched`'s work on a [T, H, W, 3] uint8 HSV tensor
    where it lies: returns the [T - 1] fp32 scores on the same device."""
    import torch
    x = hsv.to(torch.int16)
    delta = (x[1:] - x[:-1]).abs().float()
    return delta.mean(dim=(1, 2)).sum(dim=-1) / 3.0


def detect_scenes(video_path: str, threshold: float = 30.0,
                  min_scene_len: int = 15,
                  downscale_width: int = 256) -> tuple[list[tuple[int, int]], VideoInfo]:
    """ContentDetector-equivalent scene cuts.

    Returns ([(start_frame, end_frame), ...], VideoInfo). An empty list
    means "no cuts found" (callers fall back to uniform sampling, like
    the reference at video_processing.py:224-226,431).
    """
    if cv2 is None:
        raise RuntimeError("OpenCV not available")
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"Could not open video: {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    info = VideoInfo(fps=fps, frame_count=total)

    cuts = []
    prev_hsv = None
    last_cut = 0
    idx = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        h, w = frame.shape[:2]
        if w > downscale_width:
            scale = downscale_width / w
            frame = cv2.resize(frame, (downscale_width, int(h * scale)))
        hsv = cv2.cvtColor(frame, cv2.COLOR_BGR2HSV).astype(np.int16)
        if prev_hsv is not None:
            score = float(np.abs(hsv - prev_hsv).mean(axis=(0, 1)).sum() / 3.0)
            if score >= threshold and idx - last_cut >= min_scene_len:
                cuts.append(idx)
                last_cut = idx
        prev_hsv = hsv
        idx += 1
    cap.release()
    total = max(total, idx)

    if not cuts:
        return [], info
    bounds = [0] + cuts + [total]
    scenes = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
    return scenes, info


# ---------------------------------------------------------------------------
# Frame extraction
# ---------------------------------------------------------------------------

def _grab_frame(cap, frame_idx: int):
    cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
    ret, frame = cap.read()
    return frame if ret else None


def _write_jpeg(frame_bgr, path: str, quality: int = JPEG_QUALITY) -> None:
    cv2.imwrite(path, frame_bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])


def extract_frames_from_video(video_path: str, output_folder: str,
                              frames_per_scene: int = 2,
                              scene_threshold: float = 30.0):
    """Scene-based keyframes (reference video_processing.py:185-291).
    Returns (success, message, extracted_paths)."""
    try:
        os.makedirs(output_folder, exist_ok=True)
        scenes, info = detect_scenes(video_path, scene_threshold)
        if not scenes:
            return extract_uniform_frames(video_path, output_folder, 20)
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            return False, f"Could not open video file with OpenCV: {video_path}", []
        name = os.path.splitext(os.path.basename(video_path))[0]
        out: list[str] = []
        for i, (start, end) in enumerate(scenes):
            dur = end - start
            if dur <= 0:
                continue
            for j in range(frames_per_scene):
                frame_idx = start + int((j + 0.5) * dur / frames_per_scene)
                frame = _grab_frame(cap, frame_idx)
                if frame is None:
                    continue
                path = os.path.join(output_folder,
                                    f"{name}_scene{i:03d}_frame{j:03d}.jpg")
                _write_jpeg(frame, path)
                out.append(path)
        cap.release()
        return True, (f"Successfully extracted {len(out)} keyframes from "
                      f"{len(scenes)} scenes"), out
    except Exception as e:
        return False, f"Error processing video: {e}", []


def extract_uniform_frames(video_path: str, output_folder: str,
                           num_frames: int = 20):
    """Uniformly spaced frames (reference video_processing.py:293-359)."""
    try:
        os.makedirs(output_folder, exist_ok=True)
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            return False, f"Could not open video file: {video_path}", []
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS)
        if fps == 0:
            cap.release()
            return False, f"Could not determine FPS for video: {video_path}", []
        if total == 0 or num_frames == 0:
            cap.release()
            return True, "No frames to extract or requested.", []
        interval = max(1, total // num_frames)
        name = os.path.splitext(os.path.basename(video_path))[0]
        out: list[str] = []
        for i in range(0, total, interval):
            if len(out) >= num_frames:
                break
            frame = _grab_frame(cap, i)
            if frame is None:
                continue
            path = os.path.join(output_folder,
                                f"{name}_uniform_{len(out):03d}.jpg")
            _write_jpeg(frame, path)
            out.append(path)
        cap.release()
        return True, f"Successfully extracted {len(out)} frames uniformly", out
    except Exception as e:
        return False, f"Error extracting uniform frames: {e}", []


def _timestamp_name(prefix: str, frame_idx: int, fps: float) -> str:
    ts = frame_idx / fps if fps else 0.0
    return f"{prefix}_{int(ts // 60):02d}m{int(ts % 60):02d}s.jpg"


def _extract_timestamped(video_path: str, folder: str, prefix: str,
                         fps_target: float, threshold: float,
                         log: StatusLog) -> int:
    """Shared scene/uniform extraction with `{prefix}_{MM}m{SS}s.jpg`
    names (reference video_processing.py:424-461,513-551)."""
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        log(f"❌ Could not open video: {video_path}")
        return 0
    fps_video = cap.get(cv2.CAP_PROP_FPS) or 30.0
    total_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    scenes, _ = detect_scenes(video_path, threshold)
    count = 0
    if not scenes:
        log(f"⚠️ No scenes detected in {os.path.basename(video_path)}, using uniform sampling")
        interval = max(1, int(fps_video / max(fps_target, 1e-6)))
        targets = range(0, total_frames, interval)
        for frame_idx in targets:
            frame = _grab_frame(cap, frame_idx)
            if frame is None:
                continue
            _write_jpeg(frame, os.path.join(
                folder, _timestamp_name(prefix, frame_idx, fps_video)))
            count += 1
    else:
        log(f"✅ Detected {len(scenes)} scenes")
        for start, end in scenes:
            interval = max(1, (end - start) // max(int(fps_target), 1))
            for frame_idx in range(start, end, interval):
                frame = _grab_frame(cap, frame_idx)
                if frame is None:
                    continue
                _write_jpeg(frame, os.path.join(
                    folder, _timestamp_name(prefix, frame_idx, fps_video)))
                count += 1
    cap.release()
    return count


def extract_frames_with_progress(urls: str, folder: str, fps: float = 2,
                                 thresh: float = 30, qual: str = "720p",
                                 progress: Optional[Callable] = None) -> str:
    """URL pipeline (reference video_processing.py:361-470)."""
    if not urls:
        return "❌ No URLs provided"
    os.makedirs(folder, exist_ok=True)
    url_list = [u.strip() for u in urls.replace(",", "\n").split("\n") if u.strip()]
    if not url_list:
        return "❌ No valid URLs provided"
    log = StatusLog(lambda m, p: progress(p or 0.0, desc=m) if progress else None)
    if not YT_DLP_AVAILABLE:
        log("❌ yt-dlp not available. Please install it: pip install yt-dlp")
        return log.text

    log("🔍 Checking video availability...", 0.0)
    valid = []
    for i, url in enumerate(url_list):
        try:
            with yt_dlp.YoutubeDL({"quiet": True}) as ydl:
                ydl.extract_info(url, download=False)
            valid.append(url)
            log(f"✅ Valid URL: {url}", 0.1 * (i + 1) / len(url_list))
        except Exception as e:
            log(f"⚠️ Skipping invalid URL {url}: {e}", 0.1 * (i + 1) / len(url_list))
    if not valid:
        return "❌ No valid video URLs found"
    log(f"✅ Found {len(valid)} valid URLs", 0.1)

    total = 0
    for i, url in enumerate(valid):
        try:
            log(f"📥 Downloading video {i+1}/{len(valid)}...",
                0.1 + 0.4 * i / len(valid))
            with tempfile.TemporaryDirectory() as tmp:
                height = qual[:-1] if qual.endswith("p") else qual
                opts = {"format": f"best[height<={height}]/best",
                        "outtmpl": os.path.join(tmp, "%(id)s.%(ext)s"),
                        "quiet": True}
                with yt_dlp.YoutubeDL(opts) as ydl:
                    info = ydl.extract_info(url, download=True)
                    video_path = os.path.join(tmp, f"{info['id']}.{info['ext']}")
                log(f"🎬 Processing video {i+1}/{len(valid)}...",
                    0.5 + 0.4 * i / len(valid))
                total += _extract_timestamped(video_path, folder, info["id"],
                                              fps, thresh, log)
                log(f"✅ Extracted {total} frames from {url}",
                    0.5 + 0.4 * (i + 1) / len(valid))
        except Exception as e:
            log(f"❌ Error processing {url}: {e}",
                0.5 + 0.4 * (i + 1) / len(valid))
    return (f"✅ Completed! Extracted {total} frames from {len(valid)} "
            f"videos to {folder}")


def process_local_videos_with_progress(input_folder: str, output_folder: str,
                                       fps: float, thresh: float,
                                       progress: Optional[Callable] = None) -> str:
    """Local-folder pipeline (reference video_processing.py:472-560)."""
    if not input_folder or not output_folder:
        return "❌ Please provide input and output folders"
    os.makedirs(output_folder, exist_ok=True)
    videos = [f for f in sorted(os.listdir(input_folder))
              if f.lower().endswith((".mp4", ".avi", ".mov", ".mkv"))]
    if not videos:
        return "❌ No video files found in the input folder."
    log = StatusLog(lambda m, p: progress(p or 0.0, desc=m) if progress else None)
    log(f"📁 Found {len(videos)} videos to process", 0.0)
    total = 0
    for i, name in enumerate(videos):
        try:
            path = os.path.join(input_folder, name)
            log(f"🎬 Processing video {i+1}/{len(videos)}: {name}",
                0.2 * i / len(videos))
            prefix = os.path.splitext(name)[0]
            total += _extract_timestamped(path, output_folder, prefix,
                                          fps, thresh, log)
            log(f"✅ Extracted frames from {name}", 0.2 * (i + 1) / len(videos))
        except Exception as e:
            log(f"❌ Error processing {name}: {e}", 0.2 * (i + 1) / len(videos))
    return (f"✅ Completed! Extracted {total} frames from {len(videos)} "
            f"videos to {output_folder}")
