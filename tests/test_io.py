import json
import os

import numpy as np
import pytest

from gme_tpu.io.video import _parse_y4m, bgr_to_gray, get_video_frames
from gme_tpu.io.writers import PSNRRecords, _png_encode, write_png

try:
    import cv2

    HAS_CV2 = True
except Exception:
    HAS_CV2 = False


@pytest.mark.skipif(not HAS_CV2, reason="cv2 unavailable")
def test_bgr_to_gray_matches_cv2(rng):
    frame = rng.randint(0, 256, (32, 48, 3), np.uint8)
    assert np.array_equal(bgr_to_gray(frame), cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))


def _write_y4m(path, frames, subsampling="420"):
    h, w = frames[0].shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C{subsampling}\n".encode())
        for y in frames:
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            if subsampling == "420":
                f.write(bytes((w // 2) * (h // 2) * 2))


def test_y4m_roundtrip(tmp_path, rng):
    frames = [rng.randint(0, 256, (16, 24), np.uint8) for _ in range(3)]
    path = str(tmp_path / "clip.y4m")
    _write_y4m(path, frames)
    decoded = _parse_y4m(path)
    assert len(decoded) == 3
    for a, b in zip(frames, decoded):
        assert np.array_equal(a, b)
    via_api = get_video_frames(path)
    assert len(via_api) == 3 and np.array_equal(via_api[0], frames[0])


def test_png_encoder_roundtrip(tmp_path, rng):
    img = rng.randint(0, 256, (20, 30), np.uint8)
    data = _png_encode(img)
    assert data.startswith(b"\x89PNG")
    if HAS_CV2:
        path = str(tmp_path / "x.png")
        with open(path, "wb") as f:
            f.write(data)
        back = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        assert np.array_equal(back, img)


def test_png_color_roundtrip(tmp_path, rng):
    img = rng.randint(0, 256, (12, 17, 3), np.uint8)  # BGR
    path = str(tmp_path / "c.png")
    write_png(path, img)
    if HAS_CV2:
        back = cv2.imread(path, cv2.IMREAD_COLOR)
        assert np.array_equal(back, img)


def test_psnr_records_roundtrip_and_reference_format(tmp_path):
    path = str(tmp_path / "psnr_records.json")
    rec = PSNRRecords(path)
    rec.add(1, 22.5)
    rec.add(2, 24.0)
    rec.flush()
    again = PSNRRecords(path)
    assert again.records == {"1": 22.5, "2": 24.0}
    s = again.summary()
    assert s["count"] == 2 and abs(s["avg"] - 23.25) < 1e-9

    # reference complex-string format (utils.py cmath bug) stays readable
    with open(path, "w") as f:
        json.dump({"5": "(22.724+0j)", "6": "(18.5+0j)"}, f)
    loaded = PSNRRecords.load(path)
    assert abs(loaded["5"] - 22.724) < 1e-9 and abs(loaded["6"] - 18.5) < 1e-9


def test_native_codec_decode_matches_cv2():
    """Native FFmpeg shim == cv2 decode, bit for bit (mp4 ingest without
    OpenCV — reference utils.py:20-30 was cv2-only)."""
    import numpy as np
    import pytest

    from gme_tpu.native import loader

    pan240 = (
        "/root/reference/global_motion_estimation/resources/videos/pan240.mp4"
    )
    import os
    if not os.path.exists(pan240):
        pytest.skip("pan240 fixture not present")
    if not (loader.available() and loader.codec_available()):
        pytest.skip("native libav runtime not built")
    cv2 = pytest.importorskip("cv2")
    del cv2
    from gme_tpu.io.video import get_video_frames

    native = loader.decode_codec(pan240)
    reference = get_video_frames(pan240, native=False)
    assert len(native) == len(reference) == 207
    for a, b in zip(native[:10], reference[:10]):
        assert np.array_equal(a, b)


def test_native_true_does_not_fall_back_to_cv2(monkeypatch, tmp_path):
    """native=True must raise when the codec runtime is absent rather than
    silently decoding with cv2 (ADVICE r2)."""
    from gme_tpu.native import loader

    monkeypatch.setattr(loader, "codec_available", lambda: False)
    pan240 = (
        "/root/reference/global_motion_estimation/resources/videos/pan240.mp4"
    )
    if not os.path.exists(pan240):
        pytest.skip("pan240 fixture not present")
    with pytest.raises(RuntimeError, match="native=True"):
        get_video_frames(pan240, native=True)


def test_create_video_from_frames(tmp_path, rng):
    """Re-encoder parity shim (reference utils.py:119-136): frames named
    `{i-3}-{i}.png` re-encode to a playable video with one frame each."""
    cv2 = pytest.importorskip("cv2")
    from gme_tpu.io.video import create_video_from_frames

    frame_dir = tmp_path / "frames"
    frame_dir.mkdir()
    n = 8
    for i in range(3, n):
        img = rng.randint(0, 256, (32, 48, 3), np.uint8)
        cv2.imwrite(str(frame_dir / f"{i - 3}-{i}.png"), img)
    out = str(tmp_path / "out.avi")
    create_video_from_frames(str(frame_dir), n, out, fps=10)
    cap = cv2.VideoCapture(out)
    count = 0
    while cap.grab():
        count += 1
    cap.release()
    assert count == n - 3

    with pytest.raises(FileNotFoundError):
        create_video_from_frames(str(tmp_path / "empty"), 5, out)


def test_iter_video_frames_matches_bulk(tmp_path, rng):
    """Streaming decode yields bit-identical frames to the bulk decoder."""
    from gme_tpu.io.video import (
        FramePrefetcher,
        get_video_frames,
        iter_video_frames,
        write_y4m,
    )

    frames = [rng.randint(0, 256, (24, 32), np.uint8) for _ in range(7)]
    path = str(tmp_path / "clip.y4m")
    write_y4m(path, frames)
    bulk = get_video_frames(path)
    streamed = list(iter_video_frames(path))
    assert len(bulk) == len(streamed) == 7
    for a, b, orig in zip(bulk, streamed, frames):
        assert np.array_equal(a, b) and np.array_equal(a, orig)

    pf = FramePrefetcher(path)
    assert np.array_equal(pf.frame(6), frames[6])
    assert pf.frame(7) is None
    assert pf.count() == 7


def test_frame_prefetcher_propagates_errors(tmp_path):
    from gme_tpu.io.video import FramePrefetcher

    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"NOT A VIDEO\n")
    pf = FramePrefetcher(str(bad))
    with pytest.raises(ValueError):
        pf.frame(0)


def test_frame_prefetcher_bounded_residency(tmp_path, rng):
    """With max_ahead set, the decoder never holds more than the window past
    the release watermark — peak host memory stays flat on long clips
    (GOP-window eviction; the results loop is monotone)."""
    from gme_tpu.io.video import FramePrefetcher, write_y4m

    frames = [rng.randint(0, 256, (16, 16), np.uint8) for _ in range(64)]
    path = str(tmp_path / "long.y4m")
    write_y4m(path, frames)

    pf = FramePrefetcher(path, max_ahead=8)
    peak = 0
    for i in range(64):
        got = pf.frame(i)
        assert np.array_equal(got, frames[i])
        peak = max(peak, pf.resident())
        pf.release_below(max(0, i - 1))  # keep a 2-frame lookback window
    assert peak <= 8, f"resident peaked at {peak} > max_ahead=8"
    assert pf.frame(64) is None

    # Retired frames are gone; accessing one is an error, not silent reuse.
    with pytest.raises(RuntimeError):
        pf.frame(0)


def test_frame_prefetcher_corrupt_tail_keeps_prefix(tmp_path, rng):
    """A corrupt tail aborts only frames past the valid decoded prefix: the
    error surfaces when asking for a frame the decoder never produced, while
    already-decoded frames stay accessible (docstring contract)."""
    from gme_tpu.io.video import FramePrefetcher, write_y4m

    frames = [rng.randint(0, 256, (16, 16), np.uint8) for _ in range(4)]
    path = tmp_path / "trunc.y4m"
    write_y4m(str(path), frames)
    data = path.read_bytes()
    path.write_bytes(data[: len(data) - 300])  # truncate inside frame 3's Y

    pf = FramePrefetcher(str(path))
    for i in range(3):
        assert np.array_equal(pf.frame(i), frames[i])
    with pytest.raises(ValueError):
        pf.frame(3)


def test_frame_prefetcher_decode_seconds(tmp_path, rng):
    """decode_seconds() is None until the full decode completes, then a
    float; close() before completion keeps it None (partial decodes are
    never reported as a full decode time)."""
    from gme_tpu.io.video import FramePrefetcher, write_y4m

    frames = [rng.randint(0, 256, (16, 16), np.uint8) for _ in range(6)]
    path = str(tmp_path / "c.y4m")
    write_y4m(path, frames)

    pf = FramePrefetcher(path)
    pf.count()  # wait for completion
    assert isinstance(pf.decode_seconds(), float)

    pf2 = FramePrefetcher(path, max_ahead=2)
    assert np.array_equal(pf2.frame(0), frames[0])
    pf2.close()  # decoder blocked on the window exits without completing
    pf2._thread.join(timeout=5)
    assert pf2.decode_seconds() is None


def test_iter_video_frames_y4m_native_contract(tmp_path, rng):
    """native=True on y4m either uses the native loader or raises — it is
    never silently ignored (aligned with get_video_frames)."""
    from gme_tpu.io.video import iter_video_frames, write_y4m
    from gme_tpu.native import loader as native_loader

    frames = [rng.randint(0, 256, (16, 16), np.uint8) for _ in range(3)]
    path = str(tmp_path / "n.y4m")
    write_y4m(path, frames)
    if native_loader.available():
        got = list(iter_video_frames(path, native=True))
        assert all(np.array_equal(a, b) for a, b in zip(got, frames))
    else:
        with pytest.raises(RuntimeError):
            list(iter_video_frames(path, native=True))


def test_textured_pan_is_seeded_and_pans():
    """The synthetic clip is reproducible from its seed, and frame i+1 is
    frame i moved by the pan, up to the +-noise sensor noise on each."""
    from gme_tpu.io.synthetic import textured_pan

    a = textured_pan(3, 48, 64, pan=(1, 2), seed=5)
    b = textured_pan(3, 48, 64, pan=(1, 2), seed=5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (48, 64) and a[0].dtype == np.uint8
    assert a[0].std() > 20  # textured, not flat
    step = a[1][:-1, :-2].astype(int) - a[0][1:, 2:].astype(int)
    assert np.abs(step).max() <= 4
    neg = textured_pan(2, 48, 64, pan=(-1, -2), seed=5)
    step = neg[1][1:, 2:].astype(int) - neg[0][:-1, :-2].astype(int)
    assert np.abs(step).max() <= 4
