"""Video ingest of the PyTorch port (`reverso_tpu_torch.ingest.video`).

The eight tests of `tests/test_video.py` on the port's module (synthesized
clips through OpenCV, no network, no yt-dlp), the batched scorer on the CPU
(`device="cpu"`), and the scorer against the JAX package's on one seeded
HSV stack: int16 deltas and an fp32 mean in both, so the scores agree to
1e-4 (fp32 sums of 36,864 values of at most 255, reduced in another
order).
"""
import os
import re

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from reverso_tpu_torch.ingest.video import (
    YT_DLP_AVAILABLE,
    content_scores_batched,
    detect_scenes,
    download_video_from_url,
    extract_frames_from_video,
    extract_uniform_frames,
    is_supported_video_url,
    process_local_videos_with_progress,
)
from test_video import write_clip


def test_url_allowlist():
    assert is_supported_video_url("https://www.youtube.com/watch?v=x")
    assert is_supported_video_url("https://youtu.be/abc")
    assert is_supported_video_url("https://x.com/user/status/1")
    assert not is_supported_video_url("https://example.com/video.mp4")
    assert not is_supported_video_url(None)
    assert not is_supported_video_url(123)


def test_detect_scenes(tmp_path):
    clip = write_clip(tmp_path / "clip.avi", scenes=3)
    scenes, info = detect_scenes(clip, threshold=30.0, min_scene_len=5)
    assert len(scenes) == 3, scenes
    assert scenes[0][0] == 0
    assert abs(scenes[0][1] - 30) <= 2
    assert info.fps == 15


def test_scene_extraction_filenames(tmp_path):
    clip = write_clip(tmp_path / "myvid.avi", scenes=2)
    out = tmp_path / "frames"
    ok, msg, frames = extract_frames_from_video(clip, str(out), frames_per_scene=2)
    assert ok, msg
    names = sorted(os.path.basename(f) for f in frames)
    assert names[0] == "myvid_scene000_frame000.jpg"   # reference scheme
    assert len(frames) == 4
    assert all(os.path.exists(f) for f in frames)


def test_uniform_extraction(tmp_path):
    clip = write_clip(tmp_path / "uni.avi", scenes=1, frames_per_scene=40)
    out = tmp_path / "frames"
    ok, msg, frames = extract_uniform_frames(clip, str(out), num_frames=5)
    assert ok and len(frames) == 5
    assert os.path.basename(frames[0]) == "uni_uniform_000.jpg"


def test_local_pipeline_timestamp_names(tmp_path):
    (tmp_path / "vids").mkdir()
    write_clip(tmp_path / "vids" / "a.avi", scenes=2)
    out = tmp_path / "frames"
    msg = process_local_videos_with_progress(str(tmp_path / "vids"), str(out),
                                             fps=2, thresh=30.0)
    assert msg.startswith("✅ Completed!"), msg
    names = os.listdir(out)
    assert names
    assert all(re.match(r"a_\d{2}m\d{2}s\.jpg", n) for n in names), names


def test_local_pipeline_empty_folder(tmp_path):
    (tmp_path / "empty").mkdir()
    msg = process_local_videos_with_progress(str(tmp_path / "empty"),
                                             str(tmp_path / "out"), 2, 30.0)
    assert msg.startswith("❌ No video files")


def test_download_gating(tmp_path):
    if YT_DLP_AVAILABLE:
        pytest.skip("yt-dlp installed")
    ok, msg, path = download_video_from_url(
        "https://youtube.com/watch?v=x", str(tmp_path / "nowhere"))
    assert not ok and "yt-dlp not available" in msg


def test_batched_scorer_matches_loop(tmp_path):
    clip = write_clip(tmp_path / "clip.avi", scenes=2, frames_per_scene=10)
    cap = cv2.VideoCapture(clip)
    frames = []
    while True:
        ret, f = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2HSV))
    cap.release()
    hsv = np.stack(frames)
    scores = content_scores_batched(hsv, device="cpu")
    assert scores.dtype == np.float32 and scores.shape[0] == hsv.shape[0] - 1
    # the scene cut transition must be the clear maximum
    assert scores.argmax() == 9
    # the per-frame loop of `detect_scenes`
    loop = [np.abs(hsv[i + 1].astype(np.int16) - hsv[i]).mean(axis=(0, 1)).sum() / 3.0
            for i in range(len(hsv) - 1)]
    np.testing.assert_allclose(scores, loop, atol=1e-4, rtol=0)


def test_batched_scorer_matches_jax():
    from reverso_tpu.ingest.video import content_scores_batched as jax_scores

    hsv = np.random.default_rng(5).integers(0, 256, (40, 36, 64, 3), dtype=np.uint8)
    hsv[20:] //= 3                       # one cut
    want = np.asarray(jax_scores(hsv))
    got = content_scores_batched(hsv, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got.argmax() == want.argmax() == 19
