"""Benchmark: full results-pipeline throughput (pairs/s) on one GPU,
swept over 240p / 480p / 720p.

Runs the complete per-pair GME pipeline (3-level pyramid, dense diamond
init, hierarchical robust affine fit, dense field, compensation, PSNR) over
whole videos as batched device programs:

- 240p: the reference's committed fixture pan240.mp4 (320x240, 206 pairs).
- 480p / 720p: cubic upscales of pan240 (the BASELINE.md methodology — the
  reference CPU 720p number was measured on exactly such an upscale).

Each resolution compiles and runs once (set-up, not timed), then times three
whole-video passes on the host clock; a pass dispatches every batch and ends
in `jax.block_until_ready` on all outputs.  Headline = median pass.  Needs a
GPU: exits non-zero without one, and prints the card's name and power limit
beside the numbers.

Baselines (BASELINE.md: the reference pipeline on a CPU):
    pan240  (320x240):  2.575  pairs/s
    pan480  (640x480):  0.4672 pairs/s
    pan720 (1280x720):  0.1915 pairs/s

The headline metric is the 720p north-star (BASELINE.json: >=50x reference
CPU => >=9.57 pairs/s).  Prints ONE JSON line to stdout:
{"metric", "value", "unit", "vs_baseline"}; per-resolution detail goes to
stderr.
"""

import json
import os
import sys
import time

import numpy as np

# Reference CPU pairs/s measured locally (BASELINE.md).
BASELINES = {"240p": 2.575, "480p": 0.4672, "720p": 0.1915}
SIZES = {"240p": (240, 320), "480p": (480, 640), "720p": (720, 1280)}

PAN240 = "/root/reference/global_motion_estimation/resources/videos/pan240.mp4"

METHOD = (
    "whole-video passes after one untimed compile+run pass; wall = dispatch "
    "all batches + block_until_ready on every output; headline = median of 3"
)


def _load_pan240():
    if os.path.exists(PAN240):
        try:
            from gme_tpu.io.video import get_video_frames

            return np.stack(get_video_frames(PAN240))
        except Exception:
            pass
    # Synthetic fallback: 207 panning frames, same geometry as pan240.
    rng = np.random.RandomState(0)
    base = rng.randint(0, 256, (480, 640), np.uint8)
    return np.stack([base[i : i + 240, 2 * i : 2 * i + 320] for i in range(207)])


def _upscale(frames: np.ndarray, hw) -> np.ndarray:
    H, W = hw
    try:
        import cv2

        return np.stack(
            [cv2.resize(f, (W, H), interpolation=cv2.INTER_CUBIC) for f in frames]
        )
    except Exception:
        # Dependency-free fallback: nearest-neighbour repeat (integer ratios).
        ry, rx = H // frames.shape[1], W // frames.shape[2]
        return np.repeat(np.repeat(frames, ry, axis=1), rx, axis=2)


def _run_resolution(frames: np.ndarray, batch: int):
    import jax
    import jax.numpy as jnp

    from gme_tpu.config import GMEConfig
    from gme_tpu.models.gme import gme_pipeline_batch

    cfg = GMEConfig()
    n_pairs = frames.shape[0] - 1
    device_frames = jax.block_until_ready(jnp.asarray(frames))

    @jax.jit
    def step(prev, curr):
        out = gme_pipeline_batch(prev, curr, cfg)
        # psnr + the escape diagnostic (exact — counts are small integers).
        return jnp.stack(
            [out["psnr"], out["volume_edge_hits"].astype(jnp.float32)]
        )

    def one_pass():
        t0 = time.perf_counter()
        outs = []
        for lo in range(0, n_pairs, batch):
            idx = np.arange(lo, min(lo + batch, n_pairs))
            if len(idx) < batch:  # pad to keep one compiled shape
                idx = np.concatenate([idx, np.full(batch - len(idx), n_pairs - 1)])
            outs.append(step(device_frames[idx], device_frames[idx + 1]))
        jax.block_until_ready(outs)
        wall = time.perf_counter() - t0
        drained = np.concatenate([np.asarray(o) for o in outs], axis=1)
        return wall, drained[0, :n_pairs], drained[1, :n_pairs].astype(np.int64)

    one_pass()  # compile + first run: set-up, not timed
    walls = []
    for _ in range(3):
        w, psnr, hits = one_pass()
        walls.append(w)
    dt = float(np.median(walls))
    return n_pairs / dt, dt, walls, psnr, hits, n_pairs


def main():
    import subprocess

    import jax

    from gme_tpu.utils import compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX found {dev.platform})")
    compilation_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    pan240 = _load_pan240()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count(), "card": card}
    detail = {"device": device, "method": METHOD}
    results = {}
    for name in ("240p", "480p", "720p"):
        frames = pan240 if name == "240p" else _upscale(pan240, SIZES[name])
        batch = {"240p": 206, "480p": 103, "720p": 24}[name]
        fps, dt, walls, psnrs, hits, n_pairs = _run_resolution(frames, batch)
        results[name] = fps
        detail[name] = {
            "pairs_per_s": round(fps, 3),
            "vs_baseline": round(fps / BASELINES[name], 2),
            "wall_s": round(dt, 3),
            "walls_s": [round(w, 3) for w in walls],
            "n_pairs": int(n_pairs),
            "batch": batch,
            "psnr_avg": round(float(psnrs.mean()), 3),
            "psnr_min": round(float(psnrs.min()), 3),
            "psnr_max": round(float(psnrs.max()), 3),
            "radius_ring_visited_pairs": int((hits > 0).sum()),
        }
        print(json.dumps({name: detail[name]}), file=sys.stderr)

    # Headline: the 720p north-star (BASELINE.json >=50x => >=9.57 pairs/s).
    print(
        json.dumps(
            {
                "metric": "gme_pipeline_pairs_per_s_pan720",
                "value": round(results["720p"], 3),
                "unit": "pairs/s/card",
                "vs_baseline": round(results["720p"] / BASELINES["720p"], 2),
                "device": device,
                "method": METHOD,
            }
        )
    )
    print(json.dumps({"detail": detail}), file=sys.stderr)


if __name__ == "__main__":
    main()
