"""The results pipeline — the framework's `train()`-equivalent driver.

Re-design of reference results.py:14-112: decode the video on a
background thread (streaming prefetch) while running the full per-pair step
(GME -> affine field -> compensation -> PSNR) as a *batched, jitted* device
program over many frame pairs at once, instead of the reference's serial
decode-everything-then-loop (results.py:41, utils.py:9-31).  Host I/O (PNG
streams, JSON records) overlaps device compute via async dispatch; the
`decode_wait` stage in summary.json records how long the driver actually
blocked on the decoder (decode runs concurrently under `decode`).

Output layout matches reference README.md:103-127 / results.py:28-33, and
file naming matches results.py:62-106 (including the reference's `idx-5`
naming of the frames/compensated streams):

    <out>/<video>/{frames,compensated,curr_prev_diff,curr_comp_diff,
                   model_motion_field}/*.png
    <out>/<video>/psnr_records.json
    <out>/<video>/summary.json            (new: aggregate stats + timings)

Unlike the reference (which rmtree's prior results at startup,
results.py:23-24), outputs are idempotent and `resume=True` skips frame
indices whose records already exist — the results directory doubles as the
restart ledger (failure recovery, SURVEY.md §5).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gme_tpu.config import PipelineConfig
from gme_tpu.io.draw import draw_motion_field
from gme_tpu.io.video import FramePrefetcher
from gme_tpu.io.writers import PSNRRecords, write_png
from gme_tpu.models.gme import gme_pipeline_batch
from gme_tpu.utils import compilation_cache
from gme_tpu.utils.profiling import StageTimer, maybe_profile

_STREAMS = (
    "frames",
    "compensated",
    "curr_prev_diff",
    "curr_comp_diff",
    "model_motion_field",
)


def _prepare_dirs(save_path: str) -> None:
    os.makedirs(save_path, exist_ok=True)
    for s in _STREAMS:
        os.makedirs(os.path.join(save_path, s), exist_ok=True)


# Outputs the driver actually transfers off-device.  The diff-image streams
# are recomputed on host from frames already in host RAM (bit-identical
# integer math) — halving host<->device traffic per batch.
_TRANSFER_KEYS = (
    "parameters",
    "model_motion_field",
    "compensated",
    "psnr",
    "volume_edge_hits",
)


def _build_step(cfg: PipelineConfig, H: int, W: int):
    """Compile the batched per-pair step according to `cfg.mesh`.

    - mesh 1x1: single-device batched pipeline (vmap over pairs);
    - mesh Dx1: pair batch sharded over the "data" axis (DP);
    - mesh DxS: pairs over "data" AND frame rows over "space" — the full
      hierarchical robust GME under shard_map with halo exchange
      (gme_tpu.parallel.spatial).

    The returned step outputs only `_TRANSFER_KEYS` (the outer jit dead-code
    -eliminates the rest of the per-pair dict); with `write_images=False`
    only (parameters, psnr) ever leave the device.
    """
    keys = (
        _TRANSFER_KEYS
        if cfg.write_images
        else ("parameters", "psnr", "volume_edge_hits")
    )
    m = cfg.mesh
    if m.data * m.space == 1:
        if cfg.adaptive:
            from gme_tpu.models.gme import gme_pipeline_batch_adaptive

            # Host-level two-tier dispatch (jits internally; syncs on the
            # fast tier's escape certificate) — do not re-jit.
            return lambda p, c: {
                k: v
                for k, v in gme_pipeline_batch_adaptive(p, c, cfg.gme).items()
                if k in keys
            }
        base = lambda p, c: gme_pipeline_batch(p, c, cfg.gme)  # noqa: E731
    else:
        if cfg.batch_size % m.data:
            raise ValueError(
                f"batch_size={cfg.batch_size} must divide by mesh data={m.data}"
            )
        from gme_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(data=m.data, space=m.space)
        if m.space == 1:
            from gme_tpu.parallel.data_parallel import make_sharded_pipeline

            base = make_sharded_pipeline(mesh, cfg.gme)
        else:
            from gme_tpu.parallel.spatial import make_spatial_pipeline

            base = make_spatial_pipeline(mesh, cfg.gme, H, W)
    return jax.jit(
        lambda p, c: {k: v for k, v in base(p, c).items() if k in keys}
    )


def _get_writer(workers: int = 2):
    """Native async PNG writer when built, else synchronous fallback."""
    try:
        from gme_tpu.native.loader import AsyncPNGWriter, available

        if available():
            return AsyncPNGWriter(workers)
    except Exception:
        pass
    return None


def process_video(
    video_path: str,
    out_root: str = "results",
    cfg: Optional[PipelineConfig] = None,
    profile_dir: Optional[str] = None,
    max_pairs: Optional[int] = None,
    shard: Optional[Tuple[int, int]] = None,
    gop_size: int = 16,
) -> Dict:
    """Run the full pipeline over one video; returns the summary dict.

    `shard=(shard_id, num_shards)` selects this process's GOPs: frame pairs
    group into GOPs of `gop_size` and GOP g belongs to shard g % num_shards
    (multi-host orchestration, gme_tpu.parallel.multihost: each host decodes
    locally and writes its own psnr_records.rank<k>.json — the per-GOP work
    manifest that doubles as the elastic-recovery ledger, SURVEY.md §5).
    """
    cfg = cfg or PipelineConfig()
    fd = cfg.frame_distance
    timers = StageTimer()
    compilation_cache.enable()

    video_name = os.path.splitext(os.path.basename(video_path))[0]
    save_path = os.path.join(out_root, video_name)
    _prepare_dirs(save_path)

    # Streaming decode on a background thread (the input side of pipeline
    # parallelism, SURVEY §2.2 row 6): the device computes on early batches
    # while later frames still decode.  The reference decodes the whole
    # video upfront while everything else waits (utils.py:9-31).  Residency
    # is bounded: the decoder keeps at most `max_ahead` frames past the
    # release watermark, and `_flush` retires each batch's frames once its
    # outputs are written — peak host RAM stays flat however long the clip.
    # The window must exceed the driver's lookback/lookahead span: two
    # in-flight batches (double buffering) + frame_distance + the current
    # peek, with 2x slack.
    max_ahead = 2 * (2 * cfg.batch_size + fd + 2)
    pf = FramePrefetcher(video_path, max_ahead=max_ahead)
    with timers.stage("decode_wait"):
        first = pf.frame(0)
    if first is None:
        raise RuntimeError(f"Error reading video file: {video_path}")
    H, W = int(first.shape[0]), int(first.shape[1])

    shard_id, num_shards = shard if shard is not None else (0, 1)
    rec_name = (
        "psnr_records.json" if shard is None
        else f"psnr_records.rank{shard_id}.json"
    )
    records = PSNRRecords(os.path.join(save_path, rec_name))
    writer = _get_writer()

    bsz = cfg.batch_size
    step = _build_step(cfg, H, W)

    edge_hits_total = 0

    def _flush(pending) -> None:
        """Transfer a finished batch and write its outputs — runs while the
        NEXT batch computes on device (double buffering)."""
        nonlocal edge_hits_total
        batch_idx, out = pending
        with timers.stage("device_get"):
            out = jax.device_get(out)
        if "volume_edge_hits" in out:
            # Runtime parity diagnostic (see bbme.diamond_walk_volume): walks
            # stopped on the volume-radius boundary.  Count only real (non-
            # padding) pairs of this batch.
            edge_hits_total += int(
                sum(out["volume_edge_hits"][: len(batch_idx)])
            )
            out = {k: v for k, v in out.items() if k != "volume_edge_hits"}
        with timers.stage("write_outputs"):
            for k, idx in enumerate(batch_idx):
                _write_pair_outputs(
                    save_path,
                    idx,
                    pf.frame(idx - fd),
                    pf.frame(idx),
                    {key: out[key][k] for key in out},
                    writer,
                    write_images=cfg.write_images,
                )
                records.add(idx, float(out["psnr"][k]))
            # Image-before-record fence: drain the async PNG pool BEFORE the
            # ledger marks these pairs done, so a crash can never leave a
            # recorded pair whose image streams were lost in the queue (the
            # reference writes images synchronously before its record,
            # results.py:64-112; `--resume` trusts the ledger).  The drain
            # still overlaps the NEXT batch's device compute.
            if writer is not None and cfg.write_images:
                writer.drain()
            records.flush()

    def _dispatch(batch_idx):
        """Upload one (possibly padded) batch and enqueue the device step;
        JAX dispatch is asynchronous, so host PNG/JSON writes of the
        PREVIOUS batch overlap this batch's device compute (the reference's
        loop is strictly serial, results.py:41)."""
        pad = bsz - len(batch_idx)
        idx_arr = np.array(batch_idx + [batch_idx[-1]] * pad, dtype=np.int32)
        with timers.stage("dispatch"):
            prev = jnp.asarray(
                np.stack([pf.frame(i - fd) for i in idx_arr])
            )
            curr = jnp.asarray(np.stack([pf.frame(i) for i in idx_arr]))
            return step(prev, curr)

    n_processed = 0
    t_start = time.perf_counter()
    with maybe_profile(profile_dir):
        pending = None
        batch: List[int] = []
        idx = fd
        while True:
            if max_pairs is not None and idx - fd >= max_pairs:
                break
            with timers.stage("decode_wait"):
                fr = pf.frame(idx)
            if fr is None:
                break
            keep = True
            if num_shards > 1 and (
                ((idx - fd) // gop_size) % num_shards != shard_id
            ):
                keep = False
            if cfg.resume and str(idx) in records.records:
                keep = False
            if keep:
                batch.append(idx)
                n_processed += 1
                if len(batch) == bsz:
                    out = _dispatch(batch)
                    if pending is not None:
                        _flush(pending)
                    pending = (batch, out)
                    batch = []
            # GOP-window eviction: retire frames below every live window —
            # the loop's own lookback (idx - fd), the accumulating batch,
            # and the not-yet-flushed pending batch.  Keeps the bounded
            # decoder moving even when resume/shard skipping scans far
            # ahead without dispatching.
            low = idx - fd
            if batch:
                low = min(low, batch[0] - fd)
            if pending is not None:
                low = min(low, pending[0][0] - fd)
            pf.release_below(low)
            idx += 1
        if batch:
            out = _dispatch(batch)
            if pending is not None:
                _flush(pending)
            pending = (batch, out)
        if pending is not None:
            _flush(pending)
    wall = time.perf_counter() - t_start

    if writer is not None:
        writer.drain()
    pf.close()  # stop a decoder still streaming past a max_pairs early exit
    ds = pf.decode_seconds()  # synchronized; None unless decode COMPLETED
    if ds is not None:
        timers.add("decode", ds)

    summary = {
        "video": video_name,
        "frame_shape": [H, W],
        "pairs_processed": n_processed,
        "frame_distance": fd,
        "wall_s": wall,
        "pairs_per_s": n_processed / wall if wall > 0 else None,
        "volume_edge_hits": edge_hits_total,
        "psnr": records.summary(),
        "stages": timers.summary(),
    }
    if shard is not None:
        summary["shard"] = {"id": shard_id, "num_shards": num_shards,
                            "gop_size": gop_size}
    sum_name = (
        "summary.json" if shard is None else f"summary.rank{shard_id}.json"
    )
    with open(os.path.join(save_path, sum_name), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _write_pair_outputs(
    save_path: str,
    idx: int,
    previous: np.ndarray,
    current: np.ndarray,
    out: Dict[str, np.ndarray],
    writer,
    write_images: bool = True,
) -> None:
    if not write_images:
        return

    def emit(stream: str, name: str, img: np.ndarray) -> None:
        path = os.path.join(save_path, stream, f"{name}.png")
        if writer is not None and img.ndim == 2:
            writer.submit(path, img)
        else:
            write_png(path, img)

    def diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        # host-side twin of ops.metrics.frame_difference (exact int math)
        return np.abs(a.astype(np.int32) - b.astype(np.int32)).astype(np.uint8)

    # Reference naming: frames/compensated keyed by idx-5 (results.py:64-77),
    # diffs and the needle diagram keyed by idx (results.py:86-106).
    emit("frames", str(idx - 5), previous)
    emit("compensated", str(idx - 5), out["compensated"])
    emit("curr_prev_diff", str(idx), diff(current, previous))
    emit("curr_comp_diff", str(idx), diff(current, out["compensated"]))
    needle = draw_motion_field(previous, out["model_motion_field"])
    emit("model_motion_field", str(idx), needle)


def summarize_results(out_root: str = "results") -> List[Dict]:
    """Aggregate stats over every processed video (replaces reference
    utils.some_data / its __main__ walker, utils.py:138-188)."""
    rows = []
    for d in sorted(os.listdir(out_root)):
        rec = os.path.join(out_root, d, "psnr_records.json")
        if os.path.exists(rec):
            records = PSNRRecords(rec)
            rows.append({"video": d, **records.summary()})
    return rows
