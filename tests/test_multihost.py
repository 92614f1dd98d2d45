"""Multi-host orchestration tests (SURVEY.md §2.2 row 4): GOP sharding
across processes, per-rank manifests, kill-restart-resume recovery, and a
real 2-process `jax.distributed` bring-up on CPU."""

import json
import os
import subprocess
import sys
import socket
import textwrap

import numpy as np
import pytest

from gme_tpu.config import GMEConfig, PipelineConfig
from gme_tpu.io.video import get_video_frames, write_y4m
from gme_tpu.parallel.multihost import merge_rank_records, process_video_multihost
from gme_tpu.pipeline.results import process_video


def _tiny_video(tmp_path, H=48, W=64, N=10, name="tiny.y4m"):
    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (H, W), np.uint8)
    frames = [np.roll(base, (i, -2 * i), (0, 1)) for i in range(N)]
    path = str(tmp_path / name)
    write_y4m(path, frames)
    return path


_FAST = GMEConfig(volume_radius=8, dense_volume_radius=8)


def test_y4m_roundtrip(tmp_path):
    path = _tiny_video(tmp_path)
    frames = get_video_frames(path)
    assert len(frames) == 10 and frames[0].shape == (48, 64)
    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (48, 64), np.uint8)
    assert np.array_equal(frames[0], base)  # lossless luma round-trip


def test_gop_shards_partition_and_merge(tmp_path):
    """2 uncoordinated shard runs == the single-process run, record for
    record, after merging the rank manifests."""
    path = _tiny_video(tmp_path)
    cfg = PipelineConfig(gme=_FAST, batch_size=4, write_images=False)

    single = process_video(path, out_root=str(tmp_path / "single"), cfg=cfg)
    assert single["pairs_processed"] == 9

    out2 = str(tmp_path / "sharded")
    for pid in range(2):
        process_video_multihost(
            path, out_root=out2, cfg=cfg,
            num_processes=2, process_id=pid, gop_size=3,
        )
    merged = merge_rank_records(os.path.join(out2, "tiny"))

    with open(os.path.join(str(tmp_path / "single"), "tiny",
                           "psnr_records.json")) as f:
        ref = json.load(f)
    assert set(merged) == set(ref)
    for k in ref:
        assert abs(merged[k] - ref[k]) < 1e-4, k


def test_shard_restart_resume(tmp_path):
    """Kill-restart recovery: a rank that died mid-run re-processes only
    its missing pairs (the rank manifest is the recovery ledger)."""
    path = _tiny_video(tmp_path)
    cfg = PipelineConfig(gme=_FAST, batch_size=2, write_images=False)
    out = str(tmp_path / "r")

    # rank 0 "dies" after its first 2 pairs
    partial = process_video_multihost(
        path, out_root=out, cfg=cfg, num_processes=2, process_id=0,
        gop_size=2, max_pairs=4,
    )
    assert partial["pairs_processed"] == 2
    rec = os.path.join(out, "tiny", "psnr_records.rank0.json")
    with open(rec) as f:
        first = json.load(f)
    assert len(first) == 2

    # restart with resume: only the missing pairs run
    resumed = process_video_multihost(
        path, out_root=out, cfg=cfg.replace(resume=True),
        num_processes=2, process_id=0, gop_size=2,
    )
    with open(rec) as f:
        full = json.load(f)
    assert set(first) <= set(full)
    assert resumed["pairs_processed"] == len(full) - len(first)

    # rank 1 + merge completes the video
    process_video_multihost(path, out_root=out, cfg=cfg,
                            num_processes=2, process_id=1, gop_size=2)
    merged = merge_rank_records(os.path.join(out, "tiny"))
    assert sorted(map(int, merged)) == list(range(1, 10))


_WORKER = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    video, out, pid, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    from gme_tpu.config import GMEConfig, PipelineConfig
    from gme_tpu.parallel.multihost import process_video_multihost
    cfg = PipelineConfig(
        gme=GMEConfig(volume_radius=8, dense_volume_radius=8),
        batch_size=4, write_images=False)
    s = process_video_multihost(
        video, out_root=out, cfg=cfg, num_processes=2, process_id=pid,
        coordinator_address=f"127.0.0.1:{port}", gop_size=3)
    print("RANK", pid, "done", s["pairs_processed"])
""")


def test_two_process_jax_distributed(tmp_path):
    """Real jax.distributed bring-up: 2 CPU processes, GOP shards, global
    barrier, rank-0 merge — the full multi-host driver path."""
    path = _tiny_video(tmp_path)
    out = str(tmp_path / "dist")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, path, out, str(pid), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=240)
            outputs.append(stdout.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers hung:\n" + "\n".join(outputs))
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o

    with open(os.path.join(out, "tiny", "psnr_records.json")) as f:
        merged = json.load(f)  # written by rank 0 after the barrier
    assert sorted(map(int, merged)) == list(range(1, 10))

    # parity with the single-process run
    single = process_video(
        path, out_root=str(tmp_path / "single"),
        cfg=PipelineConfig(gme=_FAST, batch_size=4, write_images=False),
    )
    assert abs(single["psnr"]["avg"] -
               float(np.mean(list(merged.values())))) < 1e-4


def test_merge_rejects_stale_rank_manifests(tmp_path):
    """A manifest from a previous run with a different process count is an
    error, not silently merged (ADVICE r2)."""
    d = tmp_path / "v"
    d.mkdir()
    for r in range(3):  # debris: ranks 0..2
        with open(d / f"psnr_records.rank{r}.json", "w") as f:
            json.dump({str(r + 1): 20.0 + r}, f)
    with pytest.raises(RuntimeError, match="stale rank manifests"):
        merge_rank_records(str(d), num_processes=2)
    merged = merge_rank_records(str(d), num_processes=3)
    assert sorted(merged) == ["1", "2", "3"]


def test_initialize_multihost_passes_local_device_ids(monkeypatch):
    """Each process of a multi-card host gets its own card: the ids reach
    jax.distributed.initialize unchanged."""
    import jax

    from gme_tpu.parallel.mesh import initialize_multihost

    calls = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: calls.append(kw)
    )
    initialize_multihost("localhost:9955", 4, 2, local_device_ids=[2])
    assert calls == [
        dict(coordinator_address="localhost:9955", num_processes=4,
             process_id=2, local_device_ids=[2])
    ]
    initialize_multihost("localhost:9955", 1, 0, local_device_ids=[0])
    assert len(calls) == 1  # single process: no bring-up


def test_cli_local_device_ids_reach_multihost(monkeypatch, tmp_path):
    """`--local-device-ids 1,3` parses to [1, 3] and is handed to the
    multi-process driver."""
    import gme_tpu.parallel.multihost as mh
    from gme_tpu import cli

    seen = {}

    def fake(path, **kw):
        seen.update(kw)
        return {}

    monkeypatch.setattr(mh, "process_video_multihost", fake)
    cli.main(["results", "-v", str(tmp_path / "v.y4m"), "-o", str(tmp_path),
              "--num-processes", "2", "--process-id", "1",
              "--local-device-ids", "1,3"])
    assert seen["local_device_ids"] == [1, 3]
    assert seen["process_id"] == 1 and seen["num_processes"] == 2
