"""Motion compensation (block warp).

Replaces the reference's per-pixel Python warp loop (reference
motion.py:289-321).  Boundary semantics are preserved exactly:

- block size is derived from the frame/field *row* ratio
  (motion.py:303: bs = frame.shape[0] // motion_field.shape[0]);
- source pixel = (r - d[1], c - d[0]) (X=1 is the row shift, Y=0 the column
  shift — motion.py:299-300, 312-313);
- negative source indices are rejected (the reference's `assert > -1`) and
  out-of-range positive indices raise-and-skip — in both cases the output
  pixel keeps the ORIGINAL frame value (motion.py:311-318);
- pixels beyond the field's coverage (bottom/right remainders) keep their
  original value.

One implementation: a vectorised per-pixel gather
(`_warped_covered_gather`) — one fused XLA gather, one frame read and one
write per pair; tests/test_warp.py holds it to a NumPy per-pixel oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _warped_covered_gather(frame, d, bs, cov_h, cov_w):
    """(cov_h, cov_w) warped pixels via one per-pixel 2D gather (no OOB
    masking — the caller applies it)."""
    H, W = frame.shape
    d_px = jnp.repeat(jnp.repeat(d, bs, axis=0), bs, axis=1)  # (cov_h, cov_w, 2)
    rr = jnp.arange(cov_h, dtype=jnp.int32)[:, None]
    cc = jnp.arange(cov_w, dtype=jnp.int32)[None, :]
    gr = jnp.clip(rr - d_px[..., 1], 0, H - 1)
    gc = jnp.clip(cc - d_px[..., 0], 0, W - 1)
    return frame[gr, gc]


def compensate_frame(frame: jnp.ndarray, motion_field: jnp.ndarray) -> jnp.ndarray:
    """Warp `frame` by the per-block `motion_field`.

    Args:
        frame: (H, W) uint8 frame.
        motion_field: (nbh, nbw, 2) int field; channel 0 = column shift,
            channel 1 = row shift.

    Returns:
        (H, W) uint8 compensated frame.
    """
    H, W = frame.shape
    nbh, nbw = motion_field.shape[:2]
    bs = H // nbh
    cov_h, cov_w = nbh * bs, nbw * bs  # region covered by the field

    d = motion_field.astype(jnp.int32)
    warped = _warped_covered_gather(frame, d, bs, cov_h, cov_w)

    # Reference OOB semantics: a pixel whose source falls outside the frame
    # keeps its original value (motion.py:311-318).
    d_px = jnp.repeat(jnp.repeat(d, bs, axis=0), bs, axis=1)
    rr = jnp.arange(cov_h, dtype=jnp.int32)[:, None]
    cc = jnp.arange(cov_w, dtype=jnp.int32)[None, :]
    src_r = rr - d_px[..., 1]
    src_c = cc - d_px[..., 0]
    valid = (src_r >= 0) & (src_c >= 0) & (src_r < H) & (src_c < W)
    covered = jnp.where(valid, warped, frame[:cov_h, :cov_w])

    if cov_h == H and cov_w == W:
        return covered
    out = frame
    out = out.at[:cov_h, :cov_w].set(covered)
    return out


compensate_frame_jit = jax.jit(compensate_frame)
