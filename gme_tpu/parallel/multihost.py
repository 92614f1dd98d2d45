"""Multi-host orchestration: GOPs shard across processes.

The reference is single-process (SURVEY.md §2.2); here independent GOPs
(groups of `gop_size` frame pairs) shard across processes, each process
decodes the video locally (host-local I/O) and runs its GOPs through its
own devices; per-rank `psnr_records.rank<k>.json` files are the work
manifest AND the elastic-recovery ledger — a restarted host re-processes only its missing pairs
(`resume=True`), and rank 0 merges the manifests into the canonical
`psnr_records.json` after the completion barrier.

Launch one process per card — one command per card, on each host:

    gme-tpu results -v video.mp4 --num-processes 4 --process-id $RANK \\
        --coordinator host0:9955 --local-device-ids $LOCAL_CARD

`--local-device-ids` (or, equivalently, `CUDA_VISIBLE_DEVICES=$LOCAL_CARD`)
keeps each process on its own card; without it every process on a host
would open every card and run out of memory.

With `coordinator_address=None` the processes run fully uncoordinated
(still correct — GOPs are disjoint); call `merge_rank_records` once all
ranks have finished.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Sequence

from gme_tpu.config import PipelineConfig
from gme_tpu.parallel.mesh import initialize_multihost


def merge_rank_records(
    save_path: str, num_processes: Optional[int] = None
) -> Dict[str, float]:
    """Merge the psnr_records.rank*.json manifests into the canonical
    psnr_records.json (the reference's single-file layout, results.py:
    109-112).  Returns the merged record dict.

    With `num_processes`, only ranks 0..num_processes-1 are merged and any
    other rank manifest in the directory (stale debris from a previous run
    with a different process count) is an error rather than silently folded
    into the canonical records.
    """
    paths = sorted(glob.glob(os.path.join(save_path, "psnr_records.rank*.json")))
    if num_processes is not None:
        expected = {
            os.path.join(save_path, f"psnr_records.rank{r}.json")
            for r in range(num_processes)
        }
        stale = sorted(set(paths) - expected)
        if stale:
            raise RuntimeError(
                f"stale rank manifests for num_processes={num_processes}: "
                f"{[os.path.basename(p) for p in stale]} — remove them or "
                "merge with the matching process count"
            )
    merged: Dict[str, float] = {}
    for p in paths:
        with open(p) as f:
            merged.update(json.load(f))
    merged = {k: merged[k] for k in sorted(merged, key=int)}
    with open(os.path.join(save_path, "psnr_records.json"), "w") as f:
        json.dump(merged, f, indent=4)
    return merged


def process_video_multihost(
    video_path: str,
    out_root: str = "results",
    cfg: Optional[PipelineConfig] = None,
    num_processes: int = 1,
    process_id: int = 0,
    coordinator_address: Optional[str] = None,
    gop_size: int = 16,
    max_pairs: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> Dict:
    """Run this process's GOP shard of the results pipeline.

    With a coordinator address, brings up `jax.distributed` on
    `local_device_ids` (see `initialize_multihost`), waits at a global
    barrier when done, and rank 0 merges the manifests.  Without one, runs
    uncoordinated — the caller merges.
    """
    from gme_tpu.pipeline.results import process_video

    distributed = num_processes > 1 and coordinator_address is not None
    if distributed:
        initialize_multihost(
            coordinator_address, num_processes, process_id, local_device_ids
        )

    summary = process_video(
        video_path,
        out_root=out_root,
        cfg=cfg,
        max_pairs=max_pairs,
        shard=(process_id, num_processes) if num_processes > 1 else None,
        gop_size=gop_size,
    )

    if distributed:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("gme_results_done")
    if num_processes > 1 and process_id == 0 and distributed:
        video_name = os.path.splitext(os.path.basename(video_path))[0]
        merge_rank_records(os.path.join(out_root, video_name), num_processes)
    return summary
