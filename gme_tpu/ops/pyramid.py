"""Gaussian pyramid as an XLA convolution.

Bit-exact replacement for the reference's `cv2.pyrDown` loop
(reference utils.py:34-51).  OpenCV's pyrDown on uint8 is: REFLECT_101 border
padding of 2, separable 5-tap binomial kernel [1,4,6,4,1] (2-D weights sum to
256), stride-2 decimation starting at index 0, and fixed-point rounding
`(acc + 128) >> 8`.  All accumulator values are <= 255*256 = 65280, exactly
representable in float32, so the filter can run in f32 and reproduce
OpenCV bit-for-bit (verified in tests/test_pyramid.py).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
from jax import lax

# 5-tap binomial kernel with integer weights (sum 16 per axis, 256 in 2-D).


def _reflect101_pad2(img: jnp.ndarray) -> jnp.ndarray:
    """Pad by 2 on each side with REFLECT_101 (edge pixel not duplicated)."""
    return jnp.pad(img, ((2, 2), (2, 2)), mode="reflect")


_W5 = (1.0, 4.0, 6.0, 4.0, 1.0)


def _tap_matrix(n_out: int, n_in: int) -> jnp.ndarray:
    """(n_in, n_out) banded tap matrix S[x, j] = w5[x - 2j] (0 outside),
    so that `padded @ S` applies the stride-2 5-tap filter along an axis."""
    x = jax.lax.broadcasted_iota(jnp.int32, (n_in, n_out), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (n_in, n_out), 1)
    t = x - 2 * j
    s = jnp.zeros((n_in, n_out), jnp.float32)
    for k, w in enumerate(_W5):
        s = jnp.where(t == k, jnp.float32(w), s)
    return s


def pyrdown(img: jnp.ndarray) -> jnp.ndarray:
    """Downsample one pyramid level, matching cv2.pyrDown on uint8 exactly.

    The separable 5-tap stride-2 filter runs as TWO banded matmuls
    (`S_vᵀ @ padded @ S_h`) rather than `lax.conv`: a convolution library
    may pick a transform-based algorithm (Winograd-style) whose
    intermediates are non-integer.  Precision must be HIGHEST: a GPU's
    default f32 matmul is TF32, whose 10-bit mantissa cannot hold pixel
    values times tap weights exactly.  At HIGHEST the dot is exact for
    integer-valued operands (accumulators <= 255*256 < 2**24), so the
    fixed-point rounding reproduces OpenCV bit-for-bit on every backend
    (tests/test_pyramid.py).

    Args:
        img: (H, W) uint8 (or integer-valued float32) image.

    Returns:
        ((H+1)//2, (W+1)//2) uint8 image.
    """
    H, W = img.shape
    oh, ow = (H + 1) // 2, (W + 1) // 2
    x = _reflect101_pad2(img.astype(jnp.float32))
    sv = _tap_matrix(oh, H + 4)
    sh = _tap_matrix(ow, W + 4)
    v = jnp.dot(
        sv.T, x,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    acc = jnp.dot(
        v, sh,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    # OpenCV fixed-point rounding: (acc + 128) >> 8 == floor((acc + 128)/256).
    return jnp.floor((acc + 128.0) * (1.0 / 256.0)).astype(jnp.uint8)


def get_pyramids(img: jnp.ndarray, levels: int = 3) -> List[jnp.ndarray]:
    """Gaussian pyramid, list ordered coarsest-first.

    Matches reference utils.py:34-51: `levels` images, where index 0 is the
    most-downsampled and index `levels-1` is the original (the reference
    `insert(0, scaled)`s each downsample).
    """
    pyramid = [img]
    curr = img
    for _ in range(1, levels):
        curr = pyrdown(curr)
        pyramid.insert(0, curr)
    return pyramid


@partial(jax.jit, static_argnames=("levels",))
def get_pyramids_jit(img: jnp.ndarray, levels: int = 3):
    return tuple(get_pyramids(img, levels))
