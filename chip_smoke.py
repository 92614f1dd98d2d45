#!/usr/bin/env python3
"""On-card smoke test: the results pipeline on a 720p clip on an NVIDIA GPU.

    python chip_smoke.py            # one card
    python chip_smoke.py --gpus 4   # the four cards of one host, sharded paths only

One card, in order (any failed check exits non-zero):

1. Require a GPU: `jax.devices()[0].platform == "gpu"`; no CPU fallback.
2. Print the device kind and count, the JAX version, the card's name and
   power limit (nvidia-smi) and the compile-cache directory.
3. Generate a seeded 1280x720 textured clip of 49 frames panning 1 row and
   2 columns per frame (`gme_tpu.io.synthetic.textured_pan`) as y4m.
4. Run `gme_tpu.cli results -v <clip> -o <out> --batch-size 24` with images
   on, twice: 48 records, finite PSNR, five PNG streams and summary.json.
   Prints the warm run's pairs/s and the cold run's extra (compile) time.
5. Parity with the same code on the CPU backend on 4 pairs at 720p:
   parameters |diff| <= 1e-5, PSNR |diff| <= 1e-3 dB, model_motion_field
   and compensated exact.  BBME fields and the pyramid are exact integer
   sums below 2**24 (the pyramid's matmuls run at Precision.HIGHEST, not
   TF32); only the f32 closed-form affine solve may differ in its last bit,
   and any difference is printed.
6. `pytest -m gpu tests/test_gpu.py` in this process: exhaustive search
   (block 12, sw 12, MAE), three-step and 2D-log (MAE and MSE), diamond
   with the volume engine against the gather engine, and the block warp
   with out-of-frame sources — GPU against CPU at 720p, all exact.
7. `compiled.memory_analysis()` of the batched step, and the per-batch time
   of the gather and volume engines at 720p, batch 24, fenced by
   `block_until_ready` (a measurement, not a switch).

Four cards (`--gpus 4`), and nothing else:

- GOP sharding: four processes, one per card (`--local-device-ids k`),
  started before this process touches a card; the merged records must
  equal a one-card run's records.
- `--mesh data=4` and `--mesh data=1,space=4` through `process_video` on
  the same clip; every output of a sharded step must sit on 4 distinct
  devices, and the parameters must equal a one-card run of the same engine
  (gather for data, volume for space) bit for bit; PSNR records within
  1e-3 dB.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
A compact record of the run goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 720, 1280
N_FRAMES = 49  # 48 pairs: two batches of 24
BATCH = 24
PAN = (1, 2)
SEED = 0
STREAMS = (
    "frames", "compensated", "curr_prev_diff", "curr_comp_diff",
    "model_motion_field",
)
WORK = os.path.join(ROOT, "results", "chip_smoke")  # results/ is gitignored
RECORD = os.path.join(ROOT, "chiprun_out", "chip_smoke.json")

PARAM_TOL = 1e-5  # f32 closed-form solve: last-bit differences only
PSNR_TOL = 1e-3  # dB


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list:
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def make_clip(path: str) -> None:
    from gme_tpu.io.synthetic import textured_pan
    from gme_tpu.io.video import write_y4m

    write_y4m(path, textured_pan(N_FRAMES, H, W, PAN, seed=SEED))


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX found only {devs[0].platform} devices ({devs[0]})")
    check(len(devs) >= n, f"need {n} GPUs, JAX found {len(devs)}")
    return devs


def device_header(devs, rec: dict) -> None:
    """Phase 2: what runs where, and the persistent compile cache."""
    import jax

    from gme_tpu.utils import compilation_cache

    compilation_cache.enable()
    cards = card_lines()
    log(f"device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__}")
    for ln in cards:
        log(f"nvidia-smi: {ln}")
    log(f"compile cache: {compilation_cache.cache_dir()}")
    rec.update(device_kind=devs[0].device_kind, cards=cards,
               jax=jax.__version__)


def run_cli(argv) -> dict:
    """`gme_tpu.cli` in this process; returns the summary it prints."""
    import contextlib
    import io

    from gme_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


def read_records(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "clip", "psnr_records.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------

def pipeline_phase(clip: str, rec: dict) -> None:
    """Phase 4: the CLI end to end, cold then warm."""
    runs = []
    for name in ("cold", "warm"):
        out = os.path.join(WORK, name)
        t0 = time.perf_counter()
        summary = run_cli(
            ["results", "-v", clip, "-o", out, "--batch-size", str(BATCH)]
        )
        wall = time.perf_counter() - t0
        records = read_records(out)
        save = os.path.join(out, "clip")
        check(summary["pairs_processed"] == N_FRAMES - 1,
              f"{name}: {summary['pairs_processed']} pairs processed")
        check(len(records) == N_FRAMES - 1, f"{name}: {len(records)} records")
        psnr = np.array(list(records.values()), np.float64)
        check(np.isfinite(psnr).all(), f"{name}: non-finite PSNR")
        for s in STREAMS:
            n = len(os.listdir(os.path.join(save, s)))
            check(n == N_FRAMES - 1, f"{name}: stream {s} has {n} PNGs")
        check(os.path.exists(os.path.join(save, "summary.json")),
              f"{name}: summary.json missing")
        runs.append((wall, summary, records))
        log(f"phase 4 [{name}]: {len(records)} pairs, "
            f"pairs_per_s={summary['pairs_per_s']} (loop {summary['wall_s']} s,"
            f" process call {wall} s), psnr avg={psnr.mean()} "
            f"min={psnr.min()} max={psnr.max()}")
    (_, cold, cold_records), (_, warm, warm_records) = runs
    check(cold_records == warm_records, "cold and warm runs disagree")
    compile_s = cold["wall_s"] - warm["wall_s"]
    log(f"phase 4: warm pairs_per_s={warm['pairs_per_s']} at {W}x{H} batch "
        f"{BATCH} with 5 PNG streams; cold-run compile time ~{compile_s} s "
        f"(cold loop minus warm loop)")
    rec["pipeline"] = {
        "pairs_per_s_warm": warm["pairs_per_s"],
        "wall_s_warm": warm["wall_s"],
        "wall_s_cold": cold["wall_s"],
        "compile_s": compile_s,
        "stages_warm": warm["stages"],
        "psnr": warm["psnr"],
    }


def parity_phase(clip: str, gpu, rec: dict):
    """Phase 5: GPU against the CPU backend on 4 pairs; returns the GPU
    batch inputs and the compiled batched step for phase 7."""
    import jax

    from gme_tpu.config import PipelineConfig
    from gme_tpu.io.video import get_video_frames
    from gme_tpu.pipeline.results import _build_step

    frames = get_video_frames(clip)
    prev = np.stack(frames[:BATCH])
    curr = np.stack(frames[1 : BATCH + 1])
    cfg = PipelineConfig(batch_size=BATCH)  # what the CLI ran
    step = _build_step(cfg, H, W)
    prev_d, curr_d = jax.device_put(prev, gpu), jax.device_put(curr, gpu)
    on_gpu = jax.device_get(step(prev_d, curr_d))

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cpu_step = _build_step(cfg, H, W)
        on_cpu = jax.device_get(
            cpu_step(jax.device_put(prev[:4], cpu), jax.device_put(curr[:4], cpu))
        )
    g = {k: np.asarray(v)[:4] for k, v in on_gpu.items()}
    c = {k: np.asarray(v) for k, v in on_cpu.items()}
    dp = np.abs(g["parameters"].astype(np.float64) - c["parameters"]).max()
    dpsnr = np.abs(g["psnr"].astype(np.float64) - c["psnr"]).max()
    n_bits = int((g["parameters"] != c["parameters"]).sum())
    log(f"phase 5: parameters max|gpu-cpu|={dp} ({n_bits} of "
        f"{g['parameters'].size} differ), psnr max|gpu-cpu|={dpsnr} dB")
    if n_bits:
        log(f"phase 5: gpu parameters {g['parameters'].tolist()}")
        log(f"phase 5: cpu parameters {c['parameters'].tolist()}")
    check(dp <= PARAM_TOL, f"parameters differ by {dp} > {PARAM_TOL}")
    check(dpsnr <= PSNR_TOL, f"psnr differs by {dpsnr} dB > {PSNR_TOL}")
    for k in ("model_motion_field", "compensated"):
        check(np.array_equal(g[k], c[k]), f"{k}: GPU != CPU")
    records = read_records(os.path.join(WORK, "warm"))
    cli_psnr = np.array([records[str(i)] for i in range(1, 5)])
    check(np.abs(cli_psnr - c["psnr"]).max() <= PSNR_TOL,
          "CLI psnr records differ from the CPU reference")
    a0, b0 = np.median(on_gpu["parameters"][:, 0]), np.median(on_gpu["parameters"][:, 3])
    log(f"phase 5: model_motion_field and compensated identical; median "
        f"(a0, b0)=({a0}, {b0}) for a pan of {(-PAN[1], -PAN[0])} (cols, rows)")
    rec["parity"] = {"param_max_abs": float(dp), "param_bits_differ": n_bits,
                     "psnr_max_abs_db": float(dpsnr)}
    return step, prev_d, curr_d


def gpu_tests_phase(rec: dict) -> None:
    """Phase 6: the `gpu`-marked tests, in this process (one process holds
    the card)."""
    import pytest

    class Tally:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes[report.nodeid] = report.outcome

    tally = Tally()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_gpu.py")],
        plugins=[tally],
    )
    passed = sum(o == "passed" for o in tally.outcomes.values())
    log(f"phase 6: gpu tests rc={int(rc)} passed={passed} of "
        f"{len(tally.outcomes)}")
    check(int(rc) == 0 and passed == len(tally.outcomes) and passed > 0,
          f"gpu tests: {tally.outcomes}")
    rec["gpu_tests"] = tally.outcomes


def engines_phase(step, prev_d, curr_d, rec: dict) -> None:
    """Phase 7: memory of the batched step; gather vs volume per batch."""
    import jax

    from gme_tpu.config import GMEConfig, PipelineConfig
    from gme_tpu.pipeline.results import _build_step

    mem = step.lower(prev_d, curr_d).compile().memory_analysis()
    log(f"phase 7: memory_analysis of the batched step ({W}x{H}, batch "
        f"{BATCH}): {mem}")
    rec["memory_analysis"] = str(mem)
    volume = PipelineConfig(batch_size=BATCH, gme=GMEConfig(search_impl="volume"))
    times = {}
    for impl, fn in (("gather", step), ("volume", _build_step(volume, H, W))):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(prev_d, curr_d))
        first = time.perf_counter() - t0
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(prev_d, curr_d))
            ts.append(time.perf_counter() - t0)
        times[impl] = {"first_call_s": first, "batch_s": ts,
                       "median_batch_s": float(np.median(ts))}
        log(f"phase 7: {impl} engine: median {np.median(ts)} s/batch of "
            f"{BATCH} ({BATCH / np.median(ts)} pairs/s), runs {ts}, first "
            f"call {first} s")
    rec["engines"] = times


def one_card(rec: dict) -> dict:
    devs = require_gpus(1)
    gpu = devs[0]
    device_header(devs, rec)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    clip = os.path.join(WORK, "clip.y4m")
    make_clip(clip)
    log(f"phase 3: {N_FRAMES} frames {W}x{H}, pan {PAN} px/frame, seed {SEED}")

    pipeline_phase(clip, rec)
    step, prev_d, curr_d = parity_phase(clip, gpu, rec)
    gpu_tests_phase(rec)
    engines_phase(step, prev_d, curr_d, rec)
    return {"platform": gpu.platform, "kind": gpu.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_gop_children(clip: str, n: int, out: str):
    """GOP sharding, one process per card; started before this process
    opens a card."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    procs = []
    for k in range(n):
        cmd = [
            sys.executable, "-m", "gme_tpu.cli", "results", "-v", clip,
            "-o", out, "--batch-size", str(BATCH), "--no-images",
            "--num-processes", str(n), "--process-id", str(k),
            "--coordinator", f"localhost:{port}", "--local-device-ids", str(k),
            "--gop-size", str((N_FRAMES - 1) // n),
        ]
        log_f = open(os.path.join(WORK, f"gop_rank{k}.log"), "w")
        procs.append((subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log_f,
                                       stderr=subprocess.STDOUT), log_f))
    return procs


def wait_children(procs, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    try:
        for k, (p, f) in enumerate(procs):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc != 0:
                f.close()
                with open(f.name) as fh:
                    sys.stderr.write(fh.read()[-4000:])
                fail(f"GOP rank {k} exited with {rc}")
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()


def four_cards(rec: dict, n: int = 4) -> dict:
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    clip = os.path.join(WORK, "clip.y4m")
    make_clip(clip)
    gop_out = os.path.join(WORK, "gop")
    t0 = time.perf_counter()
    procs = start_gop_children(clip, n, gop_out)
    wait_children(procs, 900)
    log(f"GOP sharding: {n} processes done in {time.perf_counter() - t0} s")

    from gme_tpu.config import GMEConfig, MeshConfig, PipelineConfig
    from gme_tpu.io.video import get_video_frames
    from gme_tpu.parallel.multihost import merge_rank_records
    from gme_tpu.pipeline.results import _build_step, process_video

    devs = require_gpus(n)
    device_header(devs, rec)

    merged = merge_rank_records(os.path.join(gop_out, "clip"), n)
    frames = get_video_frames(clip)
    prev = np.stack(frames[:BATCH])
    curr = np.stack(frames[1 : BATCH + 1])

    def run(name, gme, mesh):
        cfg = PipelineConfig(batch_size=BATCH, gme=gme, mesh=mesh,
                             write_images=False)
        out = os.path.join(WORK, name)
        t0 = time.perf_counter()
        summary = process_video(clip, out_root=out, cfg=cfg)
        wall = time.perf_counter() - t0
        step = _build_step(cfg, H, W)
        res = step(prev, curr)
        log(f"{name}: process_video {summary['pairs_processed']} pairs in "
            f"{wall} s (compilation included)")
        return read_records(out), res

    one_gather, one_gather_out = run("one_gather", GMEConfig(), MeshConfig())
    check(merged == one_gather,
          "GOP-sharded records != one-card records")
    log(f"GOP sharding: merged records ({len(merged)} pairs) == one-card records")
    rec["gop_records_equal"] = True

    one_volume, one_volume_out = run(
        "one_volume", GMEConfig(search_impl="volume"), MeshConfig()
    )
    cases = (
        ("data4", GMEConfig(), MeshConfig(data=n), one_gather, one_gather_out),
        ("space4", GMEConfig(search_impl="volume"), MeshConfig(data=1, space=n),
         one_volume, one_volume_out),
    )
    for name, gme, mesh, ref_records, ref_out in cases:
        records, out = run(name, gme, mesh)
        for k, v in out.items():
            ndev = len(v.sharding.device_set)
            check(ndev == n, f"{name}: output {k} sits on {ndev} devices")
        p = np.asarray(out["parameters"])
        p_ref = np.asarray(ref_out["parameters"])
        check(np.array_equal(p, p_ref),
              f"{name}: parameters differ from one card by "
              f"{np.abs(p - p_ref).max()}")
        dpsnr = max(abs(records[k] - ref_records[k]) for k in ref_records)
        check(records.keys() == ref_records.keys() and dpsnr <= PSNR_TOL,
              f"{name}: psnr records differ by {dpsnr}")
        log(f"{name}: outputs on {n} devices; parameters == one card bit for "
            f"bit; psnr records max diff {dpsnr} dB")
        rec[name] = {"params_equal": True, "psnr_max_abs_db": dpsnr}
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card sharded paths")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    rec = {"gpus": args.gpus}
    device = one_card(rec) if args.gpus == 1 else four_cards(rec, args.gpus)
    rec["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    shutil.rmtree(WORK, ignore_errors=True)
    log(f"chip_smoke: all phases passed in {rec['seconds']} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
