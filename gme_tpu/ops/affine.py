"""Affine global-motion model: dense field generation + weighted least-squares
fit with robust outlier rejection.

Re-design of reference motion.py:33-286.  The reference
accumulates 3x3/3x1 normal equations in a per-cell Python loop
(motion.py:55-64); here the whole fit is one masked einsum over the cell
grid followed by a 3x3 solve — and the einsum partials are exactly the
quantities that `psum` over a device mesh when the cell grid is sharded
(see gme_tpu.parallel).

Conventions preserved:
- parameters [a0, a1, a2, b0, b1, b2] with displacement
  d = [a0 + a1*x + a2*y, b0 + b1*x + b2*y] for cell (x=row, y=col)
  (reference motion.py:91-105);
- normal-equation cell coordinates use the hard-coded stride 4
  (x = i*4, y = j*4 — reference motion.py:57-58, 254-255 — despite block
  size 16; kept as `coord_stride` for output parity);
- outlier rule: per-cell L1 error between BBME field and affine field,
  threshold at the value `int(0.3*N)` positions from the end of the
  ascending sort, mask cells with error strictly greater
  (reference motion.py:236-244).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gme_tpu.utils import guards


def affine_model(x, y, parameters: jnp.ndarray) -> jnp.ndarray:
    """Displacement of position (x, y) under the affine model.

    Mirrors reference motion.py:91-105 (A = [[1,x,y,0,0,0],[0,0,0,1,x,y]]).
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    p = jnp.asarray(parameters, jnp.float32)
    d0 = p[0] + p[1] * x + p[2] * y
    d1 = p[3] + p[4] * x + p[5] * y
    return jnp.stack([d0, d1], axis=-1)


def get_motion_field_affine(
    shape: Tuple[int, int], parameters: jnp.ndarray
) -> jnp.ndarray:
    """Dense (shape[0], shape[1], 2) int16 motion field from affine params.

    Mirrors reference motion.py:139-157 — per-cell displacement rounded with
    round-half-to-even (Python round(); numpy/jnp.round match).
    """
    nbh, nbw = int(shape[0]), int(shape[1])
    xs = lax.broadcasted_iota(jnp.float32, (nbh, nbw), 0)
    ys = lax.broadcasted_iota(jnp.float32, (nbh, nbw), 1)
    d = affine_model(xs, ys, parameters)  # (nbh, nbw, 2)
    return jnp.round(d).astype(jnp.int16)


def compute_first_parameters(dense_motion_field: jnp.ndarray) -> jnp.ndarray:
    """Translation-only init: a0/b0 = mean shift (reference motion.py:176-188)."""
    a0 = jnp.mean(dense_motion_field[:, :, 0].astype(jnp.float32))
    b0 = jnp.mean(dense_motion_field[:, :, 1].astype(jnp.float32))
    z = jnp.float32(0)
    return jnp.stack([a0, z, z, b0, z, z])


def parameter_projection(parameters: jnp.ndarray) -> jnp.ndarray:
    """Project params one pyramid level finer: a0 *= 2, b0 *= 2
    (reference motion.py:191-207)."""
    scale = jnp.array([2.0, 1.0, 1.0, 2.0, 1.0, 1.0], dtype=jnp.float32)
    return parameters * scale


def moments_fit_ok(
    nbh: int, nbw: int, frame_shape: Tuple[int, int], coord_stride: int
) -> bool:
    """Static overflow check for the exact integer-moment fit: every moment
    sum must fit int32.  Holds for all realistic frame sizes (up to ~1080p
    with the reference stride); larger frames fall back to the centered-f32
    accumulation."""
    n = nbh * nbw
    xmax = max((nbh - 1) * coord_stride, 1)
    ymax = max((nbw - 1) * coord_stride, 1)
    dmax = max(frame_shape)  # field displacements cannot exceed the frame
    worst = max(
        n * xmax * ymax,
        n * xmax * xmax,
        n * ymax * ymax,
        n * max(xmax, ymax) * dmax,
        n * dmax,
    )
    return worst < 2**31 - 1


def int_moments(
    motion_field: jnp.ndarray,
    inlier_mask: jnp.ndarray,
    coord_stride: int = 4,
    row0=0,
) -> jnp.ndarray:
    """Exact int32 moment sums of the normal equations over inlier cells.

    Integer summation is order-independent, so a `psum` of per-shard
    moments is BIT-IDENTICAL to the single-device sum — the distributed
    affine fit (gme_tpu/parallel/spatial.py) produces exactly the same
    parameters as the single-device fit by construction.

    Layout: [n, Σx, Σy, Σxx, Σxy, Σyy,
             Σd0, Σx·d0, Σy·d0, Σd1, Σx·d1, Σy·d1]
    with x = (row0 + i)·stride, y = j·stride (reference motion.py:57-58).
    `row0` offsets the block-row coordinate for row-band shards.
    """
    nbh, nbw = motion_field.shape[:2]
    m = inlier_mask.astype(jnp.int32)
    x = (row0 + lax.broadcasted_iota(jnp.int32, (nbh, nbw), 0)) * coord_stride
    y = lax.broadcasted_iota(jnp.int32, (nbh, nbw), 1) * coord_stride
    d0 = motion_field[..., 0].astype(jnp.int32) * m
    d1 = motion_field[..., 1].astype(jnp.int32) * m
    mx = m * x
    my = m * y
    return jnp.stack(
        [
            jnp.sum(m), jnp.sum(mx), jnp.sum(my),
            jnp.sum(mx * x), jnp.sum(mx * y), jnp.sum(my * y),
            jnp.sum(d0), jnp.sum(d0 * x), jnp.sum(d0 * y),
            jnp.sum(d1), jnp.sum(d1 * x), jnp.sum(d1 * y),
        ]
    )


def params_from_moments(moments: jnp.ndarray) -> jnp.ndarray:
    """Solve the affine normal equations from exact integer moments.

    The constant weight w = 1/(H·W) of reference motion.py:47 cancels from
    both sides of (Σ w·AᵀA) a = (Σ w·Aᵀd).  The system is mean-centered
    analytically (Σ(x-x̄) = 0), reducing to a deterministic closed-form
    2x2 solve per axis — identical on every device given identical moments.
    """
    mom = moments.astype(jnp.float32)
    n, Sx, Sy, Sxx, Sxy, Syy = mom[0], mom[1], mom[2], mom[3], mom[4], mom[5]
    guards.check(n > 0, "affine fit: empty inlier set (all cells masked out)")
    xbar = Sx / n
    ybar = Sy / n
    Gxx = Sxx - Sx * xbar
    Gxy = Sxy - Sx * ybar
    Gyy = Syy - Sy * ybar
    det = Gxx * Gyy - Gxy * Gxy
    guards.check(
        det != 0,
        "affine fit: singular normal equations (inlier cells are collinear)",
    )

    def axis_params(Sd, Sxd, Syd):
        bx = Sxd - xbar * Sd
        by = Syd - ybar * Sd
        a1 = (bx * Gyy - by * Gxy) / det
        a2 = (by * Gxx - bx * Gxy) / det
        a0 = Sd / n - a1 * xbar - a2 * ybar
        return a0, a1, a2

    a0, a1, a2 = axis_params(mom[6], mom[7], mom[8])
    b0, b1, b2 = axis_params(mom[9], mom[10], mom[11])
    return jnp.stack([a0, a1, a2, b0, b1, b2]).astype(jnp.float32)


def fit_normal_equations(
    motion_field: jnp.ndarray,
    inlier_mask: jnp.ndarray,
    frame_shape: Tuple[int, int],
    coord_stride: int = 4,
) -> jnp.ndarray:
    """Weighted least-squares affine fit from a block motion field.

    Solves, per axis, (Σ w·AᵀA) a = (Σ w·Aᵀd) with A(cell) = [1, x, y],
    x = i*stride, y = j*stride, w = 1/(H·W), restricted to inlier cells —
    the einsum form of reference motion.py:52-84 / 248-282.

    Integer motion fields within the int32 moment bound take the EXACT
    integer-moment path (`int_moments` + `params_from_moments`): bit-
    reproducible across devices, mesh shapes, and reduction orders.  Float
    fields (or oversized frames) use the mean-centered f32 einsum path.

    Args:
        motion_field: (nbh, nbw, 2) int block motion field (channel 0 fits
            the first parameter triple, channel 1 the second — reference
            motion.py:62, 79).
        inlier_mask: (nbh, nbw) bool — True where the cell participates.
        frame_shape: (H, W) of the frame the field came from (for w).
        coord_stride: cell-coordinate stride (reference quirk: 4).

    Returns:
        (6,) float32 parameters [a0,a1,a2,b0,b1,b2].
    """
    nbh, nbw = motion_field.shape[:2]
    if jnp.issubdtype(motion_field.dtype, jnp.integer) and moments_fit_ok(
        nbh, nbw, frame_shape, coord_stride
    ):
        return params_from_moments(
            int_moments(motion_field, inlier_mask, coord_stride)
        )
    return _fit_normal_equations_f32(
        motion_field, inlier_mask, frame_shape, coord_stride
    )


def _fit_normal_equations_f32(
    motion_field: jnp.ndarray,
    inlier_mask: jnp.ndarray,
    frame_shape: Tuple[int, int],
    coord_stride: int = 4,
) -> jnp.ndarray:
    """Mean-centered f32 einsum fit (fallback for float fields / frames
    beyond the int32 moment bound)."""
    nbh, nbw = motion_field.shape[:2]
    H, W = frame_shape
    w = jnp.float32(1.0 / (H * W))

    xs = lax.broadcasted_iota(jnp.float32, (nbh, nbw), 0) * coord_stride
    ys = lax.broadcasted_iota(jnp.float32, (nbh, nbw), 1) * coord_stride
    mw = inlier_mask.astype(jnp.float32) * w  # per-cell weight

    # Mean-center the coordinates before forming the normal equations — the
    # solution is algebraically identical (a0 is un-centered afterwards) but
    # the 3x3 system becomes near-block-diagonal, which keeps the float32
    # solve accurate where the reference leans on float64 (motion.py:52-65).
    wsum = jnp.sum(mw)
    guards.check(wsum > 0, "affine fit: empty inlier set (all cells masked out)")
    xbar = jnp.sum(xs * mw) / wsum
    ybar = jnp.sum(ys * mw) / wsum
    xc = xs - xbar
    yc = ys - ybar
    ones = jnp.ones((nbh, nbw), jnp.float32)
    A = jnp.stack([ones, xc, yc], axis=-1)  # (nbh, nbw, 3)

    # These two reductions are the cross-device psum points when cells shard.
    # Precision.HIGHEST forces true-f32 products (a GPU's default f32
    # matmul is TF32, ~3 decimal digits — far too coarse for a normal-
    # equation solve).
    hi = lax.Precision.HIGHEST
    G = jnp.einsum("ija,ijb,ij->ab", A, A, mw, precision=hi)  # Σ w AᵀA  (3,3)
    d = motion_field.astype(jnp.float32)
    b = jnp.einsum("ija,ijc,ij->ac", A, d, mw, precision=hi)  # Σ w Aᵀ[dx,dy]

    sol = jnp.linalg.solve(G, b)  # (3, 2) rows: [c0, a1|b1, a2|b2]
    a0 = sol[0, 0] - sol[1, 0] * xbar - sol[2, 0] * ybar
    b0 = sol[0, 1] - sol[1, 1] * xbar - sol[2, 1] * ybar
    params = jnp.stack([a0, sol[1, 0], sol[2, 0], b0, sol[1, 1], sol[2, 1]])
    return params.astype(jnp.float32)


def outlier_mask(
    gt_motion_field: jnp.ndarray,
    affine_field: jnp.ndarray,
    outlier_fraction: float = 0.3,
) -> jnp.ndarray:
    """Top-`fraction` largest-error cells masked out.

    Mirrors reference motion.py:236-244: error = L1 norm of the field
    difference; threshold = ascending-sorted errors[-int(fraction*N)];
    outliers are cells with error strictly greater.  Returns the INLIER mask.
    """
    diff = jnp.abs(
        gt_motion_field.astype(jnp.int32) - affine_field.astype(jnp.int32)
    ).sum(axis=2)
    flat = jnp.sort(diff.reshape(-1))
    n = flat.shape[0]
    threshold_index = int(outlier_fraction * n)
    # all_diffs[-k] with k==0 degenerates to all_diffs[0] — preserved.
    threshold_value = flat[(n - threshold_index) % n]
    return ~(diff > threshold_value)


@partial(jax.jit, static_argnames=("shape",))
def get_motion_field_affine_jit(shape, parameters):
    return get_motion_field_affine(shape, parameters)
