"""Command-line entry points.

Mirrors the reference CLIs with the same flags and defaults:
- `python -m gme_tpu.cli results -v <video> [-f <frame_distance>]`
  (reference results.py:114-138)
- `python -m gme_tpu.cli bbme -p <video> -fi <idx> [-pn 0] [-bs 12] [-sw 8] [-sp 1]`
  (reference bbme.py:653-714)
- `python -m gme_tpu.cli stats [results_dir]`
  (reference utils.some_data __main__ walker, utils.py:169-188)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _parse_mesh(spec: str):
    """Parse "data=2,space=4" into a MeshConfig."""
    from gme_tpu.config import MeshConfig

    kw = {}
    for part in spec.split(","):
        if not part:
            continue
        key, _, val = part.partition("=")
        if key not in ("data", "space"):
            raise SystemExit(f"unknown mesh axis {key!r} (use data=,space=)")
        kw[key] = int(val)
    return MeshConfig(**kw)


def _apply_platform(args) -> None:
    """Pin the JAX platform (`--platform`) before the backend initialises."""
    if getattr(args, "platform", None):
        import jax

        jax.config.update("jax_platforms", args.platform)


def _cmd_results(args) -> None:
    _apply_platform(args)
    from gme_tpu.config import GMEConfig, PipelineConfig
    from gme_tpu.pipeline.results import process_video

    gme = GMEConfig(
        block_size=args.block_size,
        pyramid_levels=args.levels,
        outlier_fraction=args.outlier_fraction,
        coord_stride=args.coord_stride,
        searching_procedure=args.searching_procedure,
        pnorm_distance=args.pnorm,
        search_impl=args.search_impl,
        volume_radius=args.volume_radius,
    )
    cfg = PipelineConfig(
        frame_distance=int(args.fd) if args.fd else 1,
        gme=gme,
        mesh=_parse_mesh(args.mesh),
        batch_size=args.batch_size,
        resume=args.resume,
        write_images=not args.no_images,
        adaptive=args.adaptive,
    )
    if args.num_processes > 1:
        from gme_tpu.parallel.multihost import process_video_multihost

        summary = process_video_multihost(
            args.path, out_root=args.out, cfg=cfg,
            num_processes=args.num_processes, process_id=args.process_id,
            coordinator_address=args.coordinator, gop_size=args.gop_size,
            max_pairs=args.max_pairs, local_device_ids=args.local_device_ids,
        )
    else:
        summary = process_video(
            args.path, out_root=args.out, cfg=cfg,
            profile_dir=args.profile_dir, max_pairs=args.max_pairs,
        )
    print(json.dumps(summary, indent=2))


def _cmd_bbme(args) -> None:
    import jax.numpy as jnp

    from gme_tpu.io.draw import draw_motion_field
    from gme_tpu.io.video import get_video_frames
    from gme_tpu.io.writers import write_png
    from gme_tpu.models.hierarchical_bbme import hierarchical_wrapper
    from gme_tpu.ops.bbme import get_motion_field_jit

    frames = get_video_frames(args.path)
    previous = frames[args.fi - 3]  # reference's hard-coded distance 3 (bbme.py:620)
    current = frames[args.fi]

    motion_field = np.array(
        get_motion_field_jit(
            jnp.asarray(previous),
            jnp.asarray(current),
            block_size=args.block_size,
            search_window=args.search_window,
            searching_procedure=args.searching_procedure,
            pnorm_distance=args.pnorm,
        )
    )
    hier = np.array(
        hierarchical_wrapper(
            jnp.asarray(previous),
            jnp.asarray(current),
            block_size=args.block_size,
            search_window=args.search_window,
            searching_procedure=args.searching_procedure,
        )
    )
    out_dir = os.path.join(args.out, "images")
    os.makedirs(out_dir, exist_ok=True)
    write_png(
        os.path.join(out_dir, f"{args.searching_procedure}-res.png"),
        draw_motion_field(current, motion_field),
    )
    write_png(
        os.path.join(out_dir, f"{args.searching_procedure}h-res.png"),
        draw_motion_field(previous, hier),
    )
    print(f"wrote needle diagrams to {out_dir}")


def _cmd_direct(args) -> None:
    """Direct (gradient-descent) GME between two frames — the working
    version of the reference's abandoned prototypes (gd tests/)."""
    _apply_platform(args)
    import jax.numpy as jnp

    from gme_tpu.io.video import get_video_frames
    from gme_tpu.models.direct import direct_motion_compensation
    from gme_tpu.ops.metrics import psnr

    frames = get_video_frames(args.path)
    previous = jnp.asarray(frames[args.fi - args.fd])
    current = jnp.asarray(frames[args.fi])
    params, comp = direct_motion_compensation(
        previous,
        current,
        model=args.model,
        levels=args.levels,
        iterations=args.iterations,
        learning_rate=args.lr,
    )
    out = {
        "model": args.model,
        "parameters": [float(p) for p in params],
        "psnr_before": float(psnr(current, previous)),
        "psnr_after": float(psnr(current, comp)),
    }
    if args.out:
        from gme_tpu.io.writers import write_png

        os.makedirs(args.out, exist_ok=True)
        write_png(os.path.join(args.out, f"direct_{args.fi}.png"), np.array(comp))
    print(json.dumps(out, indent=2))


def _cmd_stats(args) -> None:
    from gme_tpu.pipeline.results import summarize_results

    for row in summarize_results(args.results):
        print(f"video {row['video']}")
        for k in ("avg", "var", "std", "max", "min"):
            if k in row:
                print(f"  {k}: {row[k]:.3f}")
        print("=" * 22)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="gme_tpu", description="global motion estimation on an accelerator"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("results", help="run the full GME pipeline over a video")
    p.add_argument("-v", "--video-path", dest="path", required=True)
    p.add_argument("-f", "--frame-distance", dest="fd", default=None)
    p.add_argument("-o", "--out", default="results")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-images", action="store_true")
    p.add_argument("--profile-dir", default=None)
    # GME model knobs (defaults = reference constants, motion.py:9-10 etc.)
    p.add_argument("--block-size", type=int, default=16,
                   help="GME block size (reference BBME_BLOCK_SIZE=16)")
    p.add_argument("--levels", type=int, default=3,
                   help="pyramid levels (reference utils.py:34)")
    p.add_argument("--outlier-fraction", type=float, default=0.3,
                   help="robust-fit outlier fraction (reference motion.py:10)")
    p.add_argument("--coord-stride", type=int, default=4,
                   help="normal-equation cell stride (reference quirk: 4)")
    p.add_argument("-sp", "--searching-procedure", type=int, default=3,
                   help="0=exhaustive 1=three-step 2=2D-log 3=diamond")
    p.add_argument("-pn", "--p-norm", dest="pnorm", type=int, default=1,
                   help="0=MAE 1=MSE")
    p.add_argument("--search-impl", choices=("auto", "gather", "volume"),
                   default="auto")
    p.add_argument("--volume-radius", type=int, default=32)
    p.add_argument("--adaptive", action="store_true",
                   help="escape-guarded adaptive volume radius: try tight "
                        "radii first, recompute escaped pairs at full "
                        "radius (bit-identical results; wins when motion "
                        "stays small)")
    p.add_argument("--mesh", default="data=1,space=1",
                   help='device mesh, e.g. "data=2,space=4": pairs shard '
                        'over data, frame rows over space (halo exchange)')
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--platform", default=None,
                   help="pin the JAX platform (e.g. cpu for the 8-vdev mesh)")
    # multi-host: GOPs shard across processes (gme_tpu.parallel.multihost)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--coordinator", default=None,
                   help="jax.distributed coordinator host:port")
    p.add_argument("--gop-size", type=int, default=16)
    p.add_argument("--local-device-ids", default=None,
                   type=lambda s: [int(t) for t in s.split(",")],
                   help="cards this process uses, e.g. 2 (one process per "
                        "card on a multi-card host)")
    p.set_defaults(func=_cmd_results)

    p = sub.add_parser("bbme", help="motion field between two frames")
    p.add_argument("-p", "--video-path", dest="path", required=True)
    p.add_argument("-fi", "--frame-index", dest="fi", type=int, required=True)
    p.add_argument("-pn", "--p-norm", dest="pnorm", type=int, default=0)
    p.add_argument("-bs", "--block-size", dest="block_size", type=int, default=12)
    p.add_argument("-sw", "--search-window", dest="search_window", type=int, default=8)
    p.add_argument(
        "-sp", "--searching-procedure", dest="searching_procedure", type=int, default=1
    )
    p.add_argument("-o", "--out", default="resources")
    p.set_defaults(func=_cmd_bbme)

    p = sub.add_parser("direct", help="direct (gradient-descent) GME on one pair")
    p.add_argument("-v", "--video-path", dest="path", required=True)
    p.add_argument("-fi", "--frame-index", dest="fi", type=int, required=True)
    p.add_argument("-f", "--frame-distance", dest="fd", type=int, default=1)
    p.add_argument("--model", choices=("affine", "perspective"),
                   default="perspective")
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--iterations", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("-o", "--out", default=None,
                   help="write the compensated frame PNG here")
    p.add_argument("--platform", default=None)
    p.set_defaults(func=_cmd_direct)

    p = sub.add_parser("stats", help="aggregate PSNR stats over results")
    p.add_argument("results", nargs="?", default="results")
    p.set_defaults(func=_cmd_stats)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
