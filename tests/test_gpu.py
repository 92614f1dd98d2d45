"""GPU = CPU parity of every search procedure, engine and the warp at 720p.

Each case compiles one path for the card at the pipeline's real width and
compares it with the same code on the CPU backend.  All comparisons are
exact: DFD costs are integer sums below 2**24, so f32 holds them exactly
in any summation order, and nothing on these paths is a matmul (so TF32
cannot enter).  These tests skip without a GPU; `python chip_smoke.py`
runs them on the card.
"""

import jax
import numpy as np
import pytest

from gme_tpu.config import DIAMOND, EXHAUSTIVE, MAE, MSE, THREESTEP, TWODLOG
from gme_tpu.io.synthetic import textured_pan
from gme_tpu.ops.bbme import get_motion_field
from gme_tpu.ops.warp import compensate_frame

pytestmark = pytest.mark.gpu

H, W = 720, 1280


@pytest.fixture(scope="module")
def pair():
    prev, curr = textured_pan(2, H, W, pan=(1, 2), seed=1)
    return prev, curr


def _run(device, fn, *args):
    """jit `fn` and run it on `device` (inputs committed there)."""
    args = [jax.device_put(a, device) for a in args]
    return np.asarray(jax.jit(fn)(*args))


def _gpu_and_cpu(gpu, fn, *args):
    return _run(gpu, fn, *args), _run(jax.devices("cpu")[0], fn, *args)


@pytest.mark.parametrize(
    "procedure,pnorm",
    [
        # BASELINE.json's exhaustive configuration: block 12, sw 12, MAE.
        (EXHAUSTIVE, MAE),
        (THREESTEP, MAE),
        (THREESTEP, MSE),
        (TWODLOG, MAE),
        (TWODLOG, MSE),
    ],
)
def test_search_gpu_matches_cpu(gpu, pair, procedure, pnorm):
    def fn(p, c):
        return get_motion_field(
            p, c, block_size=12, search_window=12,
            searching_procedure=procedure, pnorm_distance=pnorm,
        )

    on_gpu, on_cpu = _gpu_and_cpu(gpu, fn, *pair)
    np.testing.assert_array_equal(on_gpu, on_cpu)


@pytest.mark.parametrize(
    "block_size,radius,scale,pnorm",
    [
        (16, 32, 1, MSE),  # the GME levels' search (full-resolution level)
        (16, 32, 1, MAE),
        (2, 16, 4, MSE),   # the dense init at the coarsest pyramid level
    ],
)
def test_diamond_volume_matches_gather_on_gpu(gpu, pair, block_size, radius,
                                              scale, pnorm):
    """The volume engine (XLA cost volume + successor map + chase) == the
    gather engine on the card, and the gather engine == the CPU."""
    prev, curr = (f[::scale, ::scale] for f in pair)

    def search(impl):
        def fn(p, c):
            return get_motion_field(
                p, c, block_size=block_size, searching_procedure=DIAMOND,
                pnorm_distance=pnorm, search_impl=impl, volume_radius=radius,
            )

        return fn

    gather_gpu, gather_cpu = _gpu_and_cpu(gpu, search("gather"), prev, curr)
    volume_gpu = _run(gpu, search("volume"), prev, curr)
    np.testing.assert_array_equal(volume_gpu, gather_gpu)
    np.testing.assert_array_equal(gather_gpu, gather_cpu)


def test_compensate_frame_gpu_matches_cpu(gpu, pair):
    """Block warp with displacements up to +-40 px, so frame-edge blocks
    read out-of-frame sources and keep their original pixels."""
    field = np.random.RandomState(2).randint(-40, 41, (H // 16, W // 16, 2))
    on_gpu, on_cpu = _gpu_and_cpu(
        gpu, compensate_frame, pair[0], field.astype(np.int16)
    )
    np.testing.assert_array_equal(on_gpu, on_cpu)
    assert (on_gpu != pair[0]).any()
