import numpy as np
import jax.numpy as jnp
import pytest

from gme_tpu.ops.metrics import frame_difference, psnr
from gme_tpu.ops.warp import _warped_covered_gather, compensate_frame

_WARP_SHAPES = [((64, 96), 16), ((48, 80), 16), ((30, 44), 4), ((33, 47), 8)]


def _np_warp(frame, mf, clip_only=False):
    """Per-pixel oracle of reference motion.py:289-321: out[r, c] =
    frame[r - d1, c - d0] for the block holding (r, c); a source outside the
    frame keeps the original pixel, and so does the uncovered remainder.
    With `clip_only`, returns the covered region read at clamped sources."""
    H, W = frame.shape
    nbh, nbw = mf.shape[:2]
    bs = H // nbh
    out = frame.copy()
    clipped = np.zeros((nbh * bs, nbw * bs), frame.dtype)
    for r in range(nbh * bs):
        for c in range(nbw * bs):
            d0, d1 = mf[r // bs, c // bs]
            sr, sc = r - d1, c - d0
            clipped[r, c] = frame[min(max(sr, 0), H - 1), min(max(sc, 0), W - 1)]
            if 0 <= sr < H and 0 <= sc < W:
                out[r, c] = frame[sr, sc]
    return clipped if clip_only else out


@pytest.mark.parametrize("shape,bs", _WARP_SHAPES)
def test_warp_gather_matches_numpy_oracle(rng, shape, bs):
    """The per-pixel gather reads clamped sources everywhere — including
    out-of-frame pixels the validity mask later overrides."""
    H, W = shape
    nbh, nbw = H // bs, W // bs
    f = rng.randint(0, 256, (H, W), np.uint8)
    d = rng.randint(-20, 21, (nbh, nbw, 2)).astype(np.int32)
    got = np.array(
        _warped_covered_gather(jnp.asarray(f), jnp.asarray(d), bs, nbh * bs, nbw * bs)
    )
    assert np.array_equal(got, _np_warp(f, d, clip_only=True))


def test_warp_matches_reference_golden(goldens):
    g = goldens("warp.npz")
    mine = np.array(compensate_frame(jnp.asarray(g["frame"]), jnp.asarray(g["mf"])))
    assert np.array_equal(mine, g["comp"])


def test_warp_zero_field_is_identity(rng):
    f = rng.randint(0, 256, (32, 48), np.uint8)
    mf = np.zeros((4, 6, 2), np.int16)
    out = np.array(compensate_frame(jnp.asarray(f), jnp.asarray(mf)))
    assert np.array_equal(out, f)


def test_warp_oob_keeps_original(rng):
    """Displacements pointing outside the frame must leave pixels unchanged
    (reference motion.py:311-318 skip semantics)."""
    f = rng.randint(0, 256, (16, 16), np.uint8)
    mf = np.full((2, 2, 2), 100, np.int16)  # source always out of range
    out = np.array(compensate_frame(jnp.asarray(f), jnp.asarray(mf)))
    assert np.array_equal(out, f)


def test_warp_pure_translation(rng):
    f = rng.randint(0, 256, (32, 32), np.uint8)
    mf = np.zeros((4, 4, 2), np.int16)
    mf[..., 0] = 2  # column shift
    mf[..., 1] = 3  # row shift
    out = np.array(compensate_frame(jnp.asarray(f), jnp.asarray(mf)))
    # interior pixels: out[r, c] = f[r-3, c-2]
    assert np.array_equal(out[3:, 2:], f[:-3, :-2])


def test_psnr_values(goldens):
    g = goldens("pan240_pipeline.npz")
    val = float(psnr(g["curr_10_11"], g["comp_10_11"]))
    assert abs(val - float(g["psnr_10_11"])) < 1e-3


def test_psnr_identical_is_minus_one(rng):
    f = rng.randint(0, 256, (8, 8), np.uint8)
    assert float(psnr(f, f)) == -1.0


def test_frame_difference(rng):
    a = rng.randint(0, 256, (8, 8), np.uint8)
    b = rng.randint(0, 256, (8, 8), np.uint8)
    d = np.array(frame_difference(a, b))
    assert np.array_equal(d, np.abs(a.astype(int) - b.astype(int)).astype(np.uint8))


@pytest.mark.parametrize("shape,bs", _WARP_SHAPES)
def test_compensate_frame_matches_numpy_oracle(rng, shape, bs):
    """compensate_frame == the per-pixel oracle, including partially
    out-of-frame blocks and the uncovered bottom/right remainders."""
    H, W = shape
    nbh, nbw = H // bs, W // bs
    f = rng.randint(0, 256, (H, W), np.uint8)
    d = rng.randint(-20, 21, (nbh, nbw, 2)).astype(np.int32)
    got = np.array(compensate_frame(jnp.asarray(f), jnp.asarray(d)))
    assert got.shape == (H, W) and got.dtype == np.uint8
    assert np.array_equal(got, _np_warp(f, d))


def test_compensate_frame_batched(rng):
    """vmap over a batch of (frame, field) pairs — the pipeline's usage."""
    import jax

    H, W, bs = 32, 48, 8
    nbh, nbw = H // bs, W // bs
    fb = rng.randint(0, 256, (3, H, W), np.uint8)
    db = rng.randint(-10, 11, (3, nbh, nbw, 2)).astype(np.int32)
    out = np.array(jax.vmap(compensate_frame)(jnp.asarray(fb), jnp.asarray(db)))
    for i in range(3):
        assert np.array_equal(out[i], _np_warp(fb[i], db[i]))
