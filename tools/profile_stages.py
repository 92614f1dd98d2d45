"""Per-stage timing of the GME pipeline on an NVIDIA GPU.

    python tools/profile_stages.py [HxW] [batch]     (default 720x1280 24)

Each stage is one jitted program over a batch of consecutive frame pairs of
a seeded textured pan (`gme_tpu.io.synthetic`), so the walks are real; its
time is the host clock around a call that ends in
`jax.block_until_ready`, min and median over a few calls after a warm-up
call (which compiles, reported separately).  Needs a GPU: exits non-zero
without one.  Prints the card's name and power limit beside the numbers.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gme_tpu.config import GMEConfig  # noqa: E402
from gme_tpu.io.synthetic import textured_pan  # noqa: E402
from gme_tpu.models import gme as M  # noqa: E402
from gme_tpu.ops import affine as A  # noqa: E402
from gme_tpu.ops import bbme as B  # noqa: E402
from gme_tpu.ops.pyramid import get_pyramids  # noqa: E402
from gme_tpu.ops.warp import compensate_frame  # noqa: E402
from gme_tpu.utils import compilation_cache  # noqa: E402

TRIALS = 5


def bench(name, fn, args, batch):
    f = jax.jit(fn)
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    lo, med = min(ts), float(np.median(ts))
    print(f"{name:40s} min {lo*1e3:9.3f} ms  median {med*1e3:9.3f} ms/batch{batch}"
          f"  {med*1e3/batch:8.3f} ms/pair   (first call {compile_s:.1f} s)",
          flush=True)


def main():
    size = sys.argv[1] if len(sys.argv) > 1 else "720x1280"
    H, W = (int(t) for t in size.split("x"))
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"profile_stages: no GPU (JAX found {dev.platform})")
    compilation_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"device_kind={dev.device_kind} count={jax.device_count()} "
          f"nvidia-smi: {card} | {H}x{W} batch {batch}", flush=True)

    cfg = GMEConfig()
    vb = jax.vmap

    def frames(shape):
        clip = np.stack(textured_pan(batch + 1, *shape, pan=(1, 2), seed=0))
        return jax.block_until_ready(
            (jax.device_put(clip[:-1], dev), jax.device_put(clip[1:], dev))
        )

    full = frames((H, W))
    bench("pyramids(prev)+pyramids(curr)",
          lambda p, c: (vb(lambda x: get_pyramids(x, 3))(p),
                        vb(lambda x: get_pyramids(x, 3))(c)),
          full, batch)
    bench(f"dense init ({H//4}x{W//4} bs2 diamond)",
          vb(lambda p, c: M.dense_motion_estimation(p, c, cfg)),
          frames((H // 4, W // 4)), batch)
    for lvl, shape in ((1, (H // 2, W // 2)), (2, (H, W))):
        args = frames(shape)
        bench(f"diamond bs16 lvl{lvl} gather",
              vb(lambda p, c: B.diamond_search(p, c, cfg.pnorm_distance, 16, -1,
                                               4096, "gather", 32)),
              args, batch)
        bench(f"cost_volume lvl{lvl} R=32 bs16",
              vb(lambda p, c: B.compute_cost_volume(p, c, 16, 32,
                                                    cfg.pnorm_distance)),
              args, batch)
        bench(f"diamond bs16 lvl{lvl} volume (vol+walk)",
              vb(lambda p, c: B.diamond_search(p, c, cfg.pnorm_distance, 16, -1,
                                               4096, "volume", 32)),
              args, batch)
    bench("global_motion_estimation",
          vb(lambda p, c: M.global_motion_estimation(p, c, cfg)), full, batch)

    def tail(p, par):
        shape = (p.shape[0] // cfg.block_size, p.shape[1] // cfg.block_size)
        return compensate_frame(p, A.get_motion_field_affine(shape, par))

    params = jnp.asarray(np.random.RandomState(0).rand(batch, 6).astype(np.float32))
    bench("affine field + warp", vb(tail), (full[0], params), batch)
    bench("gme_pipeline_batch (full)",
          lambda p, c: M.gme_pipeline_batch(p, c, cfg), full, batch)


if __name__ == "__main__":
    main()
