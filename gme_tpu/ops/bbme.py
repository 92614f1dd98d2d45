"""Block-based motion estimation (BBME) as batched XLA programs.

Re-design of the reference's per-block Python loops (reference bbme.py) into
batched, static-shape tensor programs:

- exhaustive search: a vectorised (offsets × blocks) SAD/SSD cost volume with
  out-of-frame candidate masking and first-minimum argmin tie-breaking
  (parity with reference bbme.py:105-179).
- three-step search: three static 9-candidate rounds over all blocks at once
  (parity with reference bbme.py:182-341, including its compounding-origin
  and stale-tmp quirks).
- 2D-log search: lockstep `lax.while_loop` over all blocks with per-block
  active masks (parity with reference bbme.py:344-433).
- diamond search: lockstep LDSP `lax.while_loop` + one SDSP pass (parity with
  reference bbme.py:436-534, including clamping to `dim - bs - 1` and the
  swapped SDSP offsets).

Two candidate-evaluation engines back the data-dependent searches:

- impl="gather" (what "auto" resolves to): anchor-vs-candidate DFD via
  dynamic block gathers.  Exact for any wander distance — the plain
  reference the volume engine is tested against.
- impl="volume": precompute the DFD for EVERY offset in [-R, R]^2 as a
  shift+box-sum cost volume (elementwise work, no gathers), then the walks
  only do scalar lookups into the volume.  Spatial sharding uses it
  (gme_tpu/parallel/spatial.py), since a row band's volume needs only a
  bounded halo.  DFD values are exact f32 integers either way, so results
  are bit-identical as long as a walk stays within radius R; R is derived
  exactly for three-step (its total displacement is statically bounded) and
  configurable for diamond/2D-log (walks past R read +inf and stop —
  practically unreachable for real video at the default R=32).

Motion-field convention preserved from the reference: shape
(H//bs, W//bs, 2) int32, channel 0 = column/x shift, channel 1 = row/y shift
(reference bbme.py:176-177, 338-339, 430-431, 531-532).

All DFD values (sum of abs/squared uint8 differences over blocks of <=16x16)
are integers below 2**24, exactly representable in float32, so the f32
device path is bit-exact with the reference's numpy float32 sums on any
backend and in any summation order.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gme_tpu.config import BBMEConfig, DIAMOND, EXHAUSTIVE, MAE, MSE, THREESTEP, TWODLOG

# Module-level constants stay NumPy/Python so importing the package never
# initialises a JAX backend (lets callers pin the platform first).
_INF = float("inf")


# ---------------------------------------------------------------------------
# DFD primitives (reference bbme.py:41-94)
# ---------------------------------------------------------------------------

def block_dfd(diff: jnp.ndarray, pnorm: int) -> jnp.ndarray:
    """Sum-of-abs (MAE, pnorm=0) or sum-of-squares (MSE, pnorm=1) over the
    trailing two (block) dims.  Reference bbme.py:67-94."""
    if pnorm == MAE:
        return jnp.sum(jnp.abs(diff), axis=(-2, -1))
    elif pnorm == MSE:
        return jnp.sum(diff * diff, axis=(-2, -1))
    raise ValueError(f"unknown pnorm index {pnorm}")


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _block_grid(height: int, width: int, bs: int) -> Tuple[int, int]:
    """Number of block rows/cols — identical to the reference's loop count
    (range(0, dim-(bs-1), bs) has exactly dim//bs elements)."""
    return height // bs, width // bs


def _anchor_blocks(frame: jnp.ndarray, bs: int) -> jnp.ndarray:
    """(nbh, nbw, bs, bs) f32 anchor blocks from the previous frame."""
    H, W = frame.shape
    nbh, nbw = _block_grid(H, W, bs)
    x = frame[: nbh * bs, : nbw * bs].astype(jnp.float32)
    return x.reshape(nbh, bs, nbw, bs).transpose(0, 2, 1, 3)


def _gather_blocks(frame_f32: jnp.ndarray, pos: jnp.ndarray, bs: int) -> jnp.ndarray:
    """Gather bs x bs blocks at absolute top-left positions.

    Args:
        frame_f32: (H, W) float32 frame.
        pos: (..., 2) int32 (row, col) top-left corners, already in-bounds.

    Returns:
        (..., bs, bs) float32 blocks.
    """
    ar = jnp.arange(bs, dtype=jnp.int32)
    rows = pos[..., 0:1] + ar  # (..., bs)
    cols = pos[..., 1:2] + ar  # (..., bs)
    return frame_f32[rows[..., :, None], cols[..., None, :]]


def _in_frame(pos: jnp.ndarray, bs: int, H: int, W: int) -> jnp.ndarray:
    """Reference validity test: candidate block fully inside the frame
    (bbme.py:157-162)."""
    return (
        (pos[..., 0] >= 0)
        & (pos[..., 1] >= 0)
        & (pos[..., 0] + bs - 1 <= H - 1)
        & (pos[..., 1] + bs - 1 <= W - 1)
    )


def _block_origins(nbh: int, nbw: int, bs: int) -> jnp.ndarray:
    """(nbh, nbw, 2) int32 top-left (row, col) of every block."""
    bi = lax.broadcasted_iota(jnp.int32, (nbh, nbw), 0) * bs
    bj = lax.broadcasted_iota(jnp.int32, (nbh, nbw), 1) * bs
    return jnp.stack([bi, bj], axis=-1)


# ---------------------------------------------------------------------------
# Candidate evaluators
# ---------------------------------------------------------------------------
# An evaluator maps absolute candidate positions (nbh, nbw, K, 2) plus a
# validity mask (nbh, nbw, K) to DFD costs (nbh, nbw, K), +inf where invalid.

Evaluator = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def _make_gather_evaluator(
    previous: jnp.ndarray, current: jnp.ndarray, bs: int, pnorm: int
) -> Evaluator:
    """Exact evaluator: gather candidate blocks and diff against anchors."""
    H, W = previous.shape
    anchors = _anchor_blocks(previous, bs)
    curr_f = current.astype(jnp.float32)

    def evaluate(pos: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
        safe = jnp.stack(
            [jnp.clip(pos[..., 0], 0, H - bs), jnp.clip(pos[..., 1], 0, W - bs)],
            axis=-1,
        )
        blocks = _gather_blocks(curr_f, safe, bs)
        diff = blocks - anchors[..., None, :, :]
        cost = block_dfd(diff, pnorm)
        return jnp.where(valid, cost, _INF)

    return evaluate


def _cost_volume_core(
    prev_crop: jnp.ndarray, curr_pad: jnp.ndarray, bs: int, D: int, pnorm: int
) -> jnp.ndarray:
    """(D, D, nbh, nbw) unmasked DFD volume; the window for offset index
    (i, j) is ``curr_pad[i:i+Hc, j:j+Wc]``.  Shared by the full-frame and
    row-band volume builders.  The nested lax.scan keeps every intermediate
    a single (Hc, Wc) tile — no (D, H, W) spill."""
    Hc, Wc = prev_crop.shape
    nbh, nbw = Hc // bs, Wc // bs
    assert curr_pad.shape == (Hc + D - 1, Wc + D - 1)
    idx = jnp.arange(D, dtype=jnp.int32)

    def dr_step(_, dr):
        def dc_step(__, dc):
            win = lax.dynamic_slice(curr_pad, (dr, dc), (Hc, Wc))
            diff = win - prev_crop
            per_px = jnp.abs(diff) if pnorm == MAE else diff * diff
            return None, per_px.reshape(nbh, bs, nbw, bs).sum(axis=(1, 3))

        _, row = lax.scan(dc_step, None, idx)
        return None, row

    _, cost = lax.scan(dr_step, None, idx)  # (D_dr, D_dc, nbh, nbw)
    return cost


def compute_cost_volume(
    previous: jnp.ndarray,
    current: jnp.ndarray,
    block_size: int,
    radius: int,
    pnorm: int,
) -> jnp.ndarray:
    """(nbh, nbw, D*D) DFD cost volume for all offsets in [-R, R]^2.

    Built as D^2 frame shifts + per-block box sums — elementwise work, no
    gathers.  Entry layout: k = (dr + R) * D + (dc + R).  Entries
    whose candidate block falls outside the frame are +inf (matching the
    reference's skip-on-out-of-frame, bbme.py:157-162).
    """
    H, W = previous.shape
    bs, R = block_size, radius
    nbh, nbw = _block_grid(H, W, bs)
    D = 2 * R + 1

    prev_f = previous[: nbh * bs, : nbw * bs].astype(jnp.float32)
    curr_pad = jnp.pad(current.astype(jnp.float32), ((R, R), (R, R)))[
        : nbh * bs + 2 * R, : nbw * bs + 2 * R
    ]
    cost = _cost_volume_core(prev_f, curr_pad, bs, D, pnorm)

    offsets = jnp.arange(-R, R + 1, dtype=jnp.int32)
    row0 = jnp.arange(nbh, dtype=jnp.int32) * bs
    col0 = jnp.arange(nbw, dtype=jnp.int32) * bs
    valid_r = (row0[None, :] + offsets[:, None] >= 0) & (
        row0[None, :] + offsets[:, None] <= H - bs
    )  # (D, nbh)
    valid_c = (col0[None, :] + offsets[:, None] >= 0) & (
        col0[None, :] + offsets[:, None] <= W - bs
    )  # (D, nbw)
    mask = valid_r[:, None, :, None] & valid_c[None, :, None, :]
    cost = jnp.where(mask, cost, _INF)
    return cost.reshape(D * D, nbh, nbw).transpose(1, 2, 0)  # (nbh, nbw, D*D)


def compute_cost_volume_band(
    prev_band: jnp.ndarray,
    curr_band_ext: jnp.ndarray,
    gb0: jnp.ndarray,
    frame_shape: Tuple[int, int],
    block_size: int,
    radius: int,
    pnorm: int,
) -> jnp.ndarray:
    """(T, nbw, D*D) masked DFD cost volume for a row band of blocks — the
    spatially-sharded building block (gme_tpu/parallel/spatial.py): each
    device computes the volume only for its own block rows, from its local
    previous-frame band plus halo-exchanged current-frame rows.

    Args:
        prev_band: (T*bs, Wc) float32 — previous-frame rows
            [gb0*bs, (gb0+T)*bs), zero-padded past the frame bottom.
        curr_band_ext: (T*bs + 2R, Wc + 2R) float32 — current-frame rows
            [gb0*bs - R, (gb0+T)*bs + R), zero beyond the frame (masked
            invalid below), columns padded by R.
        gb0: traced scalar — global block-row index of band row 0.
        frame_shape: global (H, W).

    Returns:
        (T, nbw, D*D) float32 volume, +inf where the candidate block falls
        outside the global frame; entry layout k = (dr + R) * D + (dc + R),
        identical to `compute_cost_volume`.
    """
    H, W = frame_shape
    bs, R = block_size, radius
    T = prev_band.shape[0] // bs
    Wc = prev_band.shape[1]
    nbw = Wc // bs
    D = 2 * R + 1
    cost = _cost_volume_core(prev_band, curr_band_ext, bs, D, pnorm)  # (D,D,T,nbw)

    offsets = jnp.arange(-R, R + 1, dtype=jnp.int32)
    row0 = (gb0 + jnp.arange(T, dtype=jnp.int32)) * bs
    col0 = jnp.arange(nbw, dtype=jnp.int32) * bs
    valid_r = (row0[None, :] + offsets[:, None] >= 0) & (
        row0[None, :] + offsets[:, None] <= H - bs
    )  # (D, T)
    valid_c = (col0[None, :] + offsets[:, None] >= 0) & (
        col0[None, :] + offsets[:, None] <= W - bs
    )  # (D, nbw)
    mask = valid_r[:, None, :, None] & valid_c[None, :, None, :]
    cost = jnp.where(mask, cost, _INF)
    return cost.reshape(D * D, T, nbw).transpose(1, 2, 0)


def volume_evaluator(
    volume: jnp.ndarray, origins: jnp.ndarray, radius: int
) -> Evaluator:
    """Evaluator backed by a precomputed cost volume: walks do only scalar
    lookups.  Positions farther than `radius` from the block origin read
    +inf (see module docstring on radius choice).

    Args:
        volume: (..., D*D) masked cost volume (full-frame or row-band).
        origins: (..., 2) absolute block origins matching volume's leading
            dims (global coordinates in the banded case).
    """
    D = 2 * radius + 1

    def evaluate(pos: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
        off = pos - origins[..., None, :]  # (..., K, 2)
        inside = (jnp.abs(off[..., 0]) <= radius) & (jnp.abs(off[..., 1]) <= radius)
        k = (jnp.clip(off[..., 0], -radius, radius) + radius) * D + (
            jnp.clip(off[..., 1], -radius, radius) + radius
        )
        cost = jnp.take_along_axis(volume, k, axis=-1)
        return jnp.where(valid & inside, cost, _INF)

    return evaluate


def _make_volume_evaluator(
    previous: jnp.ndarray, current: jnp.ndarray, bs: int, pnorm: int, radius: int
) -> Evaluator:
    """Full-frame volume evaluator."""
    H, W = previous.shape
    nbh, nbw = _block_grid(H, W, bs)
    volume = compute_cost_volume(previous, current, bs, radius, pnorm)
    return volume_evaluator(volume, _block_origins(nbh, nbw, bs), radius)


def _resolve_impl(search_impl: str) -> str:
    """The "auto" engine is gather on every backend; "volume" stays
    selectable (spatial sharding and explicit requests)."""
    if search_impl == "auto":
        return "gather"
    if search_impl not in ("gather", "volume"):
        raise ValueError(f"unknown search_impl {search_impl!r}")
    return search_impl


def _make_evaluator(
    previous, current, bs: int, pnorm: int, impl: str, radius: int
) -> Evaluator:
    if _resolve_impl(impl) == "volume":
        H, W = previous.shape
        # No point covering offsets larger than any in-frame displacement.
        radius = min(radius, max(H, W))
        return _make_volume_evaluator(previous, current, bs, pnorm, radius)
    return _make_gather_evaluator(previous, current, bs, pnorm)


def _take_best(pos: jnp.ndarray, cost: jnp.ndarray) -> jnp.ndarray:
    """First-minimum candidate position per block (== the reference's
    strict-< scan in candidate order)."""
    k = jnp.argmin(cost, axis=-1)
    return jnp.take_along_axis(pos, k[..., None, None], axis=2)[..., 0, :]


# ---------------------------------------------------------------------------
# Exhaustive search (reference bbme.py:105-179)
# ---------------------------------------------------------------------------

def exhaustive_search(
    previous: jnp.ndarray,
    current: jnp.ndarray,
    pnorm_distance: int = MAE,
    block_size: int = 4,
    search_window: int = 2,
) -> jnp.ndarray:
    """Full-scan BBME as a masked cost volume + first-minimum argmin.

    Candidate offsets span `range(-sw, sw + bs)` on both axes — the
    reference's asymmetric window (bbme.py:146-149) is preserved.  The scan
    order (window_col outer, window_row inner) fixes tie-breaking.
    """
    H, W = previous.shape
    bs, sw = block_size, search_window
    nbh, nbw = _block_grid(H, W, bs)
    D = 2 * sw + bs  # offsets per axis

    prev_f = previous[: nbh * bs, : nbw * bs].astype(jnp.float32)
    P = sw + bs  # padding so every shifted window is a static-size slice
    curr_pad = jnp.pad(current.astype(jnp.float32), ((P, P), (P, P)))

    offsets = jnp.arange(-sw, sw + bs, dtype=jnp.int32)  # (D,)

    row0 = jnp.arange(nbh, dtype=jnp.int32) * bs
    col0 = jnp.arange(nbw, dtype=jnp.int32) * bs
    valid_r = (row0[None, :] + offsets[:, None] >= 0) & (
        row0[None, :] + offsets[:, None] + bs - 1 <= H - 1
    )  # (D, nbh)
    valid_c = (col0[None, :] + offsets[:, None] >= 0) & (
        col0[None, :] + offsets[:, None] + bs - 1 <= W - 1
    )  # (D, nbw)

    def cost_for_col_offset(wc_idx):
        wc = offsets[wc_idx]

        def cost_for_row_offset(wr_idx):
            wr = offsets[wr_idx]
            win = lax.dynamic_slice(
                curr_pad, (P + wr, P + wc), (nbh * bs, nbw * bs)
            )
            diff = win - prev_f
            per_px = jnp.abs(diff) if pnorm_distance == MAE else diff * diff
            return per_px.reshape(nbh, bs, nbw, bs).sum(axis=(1, 3))

        return jax.vmap(cost_for_row_offset)(jnp.arange(D))  # (D, nbh, nbw)

    # (D_wc, D_wr, nbh, nbw) — wc is the outer (slowest) loop in the
    # reference scan order, fixing first-minimum tie-breaking.
    cost = lax.map(cost_for_col_offset, jnp.arange(D))
    mask = valid_r[None, :, :, None] & valid_c[:, None, None, :]
    cost = jnp.where(mask, cost, _INF)

    flat = cost.reshape(D * D, nbh, nbw)
    k = jnp.argmin(flat, axis=0)  # first minimum == reference strict-< scan
    dy = offsets[k // D]  # window_col
    dx = offsets[k % D]  # window_row
    return jnp.stack([dy, dx], axis=-1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Three-step search (reference bbme.py:182-341)
# ---------------------------------------------------------------------------

def _nine_offsets(step: int) -> jnp.ndarray:
    """itertools.product([-s,0,s], [-s,0,s]) with (col, row) iteration — the
    reference enumerates window_col outer, window_row inner (bbme.py:229-231).
    Returns (9, 2) int32 rows of (row_offset, col_offset) in scan order."""
    vals = [-step, 0, step]
    out = []
    for wc in vals:
        for wr in vals:
            out.append((wr, wc))
    return jnp.array(out, dtype=jnp.int32)


def threestep_search(
    previous: jnp.ndarray,
    current: jnp.ndarray,
    pnorm_distance: int = MAE,
    block_size: int = 4,
    search_window: int = 12,
    search_impl: str = "auto",
    volume_radius: int = 32,
) -> jnp.ndarray:
    """Three shrinking 9-point rounds, fully static — no data-dependent
    control flow.  Quirks preserved from the reference:

    - step sizes (2sw+bs)//{3,5,10} (bbme.py:211-213);
    - the step-3 origin compounds the accumulated offset twice
      (bbme.py:300-301: origin3 = origin2 + dx where dx already includes
      step-1's displacement);
    - if every step-3 candidate is out of frame, the step-2 displacement is
      added a second time (the reference's stale `tmp_dx/tmp_dy`,
      bbme.py:292-294 + 335-336).

    The volume radius is derived statically (2*s1 + s2 + s3 bounds every
    evaluated position), so impl="volume" is exact for three-step.
    """
    H, W = previous.shape
    bs, sw = block_size, search_window
    nbh, nbw = _block_grid(H, W, bs)

    s1 = (2 * sw + bs) // 3
    s2 = (2 * sw + bs) // 5
    s3 = (2 * sw + bs) // 10

    del volume_radius  # exact bound below supersedes the configured radius
    exact_radius = 2 * s1 + s2 + s3
    evaluate = _make_evaluator(
        previous, current, bs, pnorm_distance, search_impl, exact_radius
    )
    origins = _block_origins(nbh, nbw, bs)
    d = threestep_walk(evaluate, origins, H, W, bs, sw)
    # Channel 0 = dy (col), channel 1 = dx (row) — reference bbme.py:338-339.
    return jnp.stack([d[..., 1], d[..., 0]], axis=-1).astype(jnp.int32)


def threestep_search_radius(block_size: int, search_window: int) -> int:
    """Exact static bound on any position three-step evaluates: step-1's
    displacement is applied twice through the compounded step-3 origin, so
    2*s1 + s2 + s3 covers every candidate (reference bbme.py:211-213,
    260-301)."""
    s1 = (2 * search_window + block_size) // 3
    s2 = (2 * search_window + block_size) // 5
    s3 = (2 * search_window + block_size) // 10
    return 2 * s1 + s2 + s3


def threestep_walk(
    evaluate: Evaluator,
    origins: jnp.ndarray,
    H: int,
    W: int,
    block_size: int,
    search_window: int,
) -> jnp.ndarray:
    """The three 9-candidate rounds themselves, on any origin grid — shared
    by the full-frame search and the row-band (spatially-sharded) path
    (`origins` carries absolute/global coordinates either way, so frame
    validity and tie-breaking are identical).

    Returns the accumulated (row, col) displacement shaped like `origins`.
    """
    bs, sw = block_size, search_window
    s1 = (2 * sw + bs) // 3
    s2 = (2 * sw + bs) // 5
    s3 = (2 * sw + bs) // 10

    def round_best(center: jnp.ndarray, offs: jnp.ndarray):
        pos = center[..., None, :] + offs  # (..., 9, 2)
        valid = _in_frame(pos, bs, H, W)
        cost = evaluate(pos, valid)
        k = jnp.argmin(cost, axis=-1)  # first-min
        best = offs[k]
        any_valid = jnp.any(jnp.isfinite(cost), axis=-1)
        return best, any_valid

    # Step 1: center (0,0) always valid => displacement always found.
    best1, _ = round_best(origins, _nine_offsets(s1))
    d = best1  # (..., 2) — (dx=row, dy=col) accumulated displacement
    origin2 = origins + d

    # Step 2: center of round 2 is step-1's best position => always valid.
    best2, _ = round_best(origin2, _nine_offsets(s2))
    d = d + best2

    # Step 3 origin compounds d again (reference quirk, bbme.py:300-301).
    origin3 = origin2 + d
    best3, any3 = round_best(origin3, _nine_offsets(s3))
    # Stale-tmp quirk: when no step-3 candidate is valid, re-add step-2's
    # best (reference bbme.py:292-294 + 335-336).
    step3 = jnp.where(any3[..., None], best3, best2)
    return d + step3


# ---------------------------------------------------------------------------
# 2D-log search (reference bbme.py:344-433)
# ---------------------------------------------------------------------------

def twodlog_search(
    previous: jnp.ndarray,
    current: jnp.ndarray,
    pnorm_distance: int = MAE,
    block_size: int = 4,
    search_window: int = 12,
    max_iters: int = 4096,
    search_impl: str = "auto",
    volume_radius: int = 32,
    return_diagnostics: bool = False,
) -> jnp.ndarray:
    """Cross-pattern logarithmic search as a lockstep while-loop.

    Per-block state (x, y, step) advances until step <= 1; finished blocks
    are masked out.  Candidate lists are padded to 9 entries; ordering within
    each mode matches the reference scan order so first-minimum tie-breaking
    is identical (cross: center,+x,-x,+y,-y — bbme.py:389-393; step==2:
    row-major 3x3 neighbourhood — bbme.py:396-398).

    With ``return_diagnostics=True`` also returns ``volume_edge_hits``: the
    number of walks (volume engine only) that ever evaluated a candidate
    which COULD lie outside the volume radius, i.e. whose displacement plus
    the current step reached the radius — the runtime detector for the
    volume-radius approximation of the reference's unbounded-within-clamps
    walk (reference bbme.py:381: `while step > 1` with no displacement
    bound).  Zero ==> results bit-identical to the unbounded gather engine.
    """
    H, W = previous.shape
    bs, sw = block_size, search_window
    nbh, nbw = _block_grid(H, W, bs)

    radius = max(volume_radius, 2 * sw)
    volume_engine = _resolve_impl(search_impl) == "volume"
    evaluate = _make_evaluator(
        previous, current, bs, pnorm_distance, search_impl, radius
    )
    origins = _block_origins(nbh, nbw, bs)

    x0 = origins[..., 0]
    y0 = origins[..., 1]
    step0 = jnp.full((nbh, nbw), sw, dtype=jnp.int32)
    # dx, dy initialised to 0 per block (reference bbme.py:371); they are
    # always overwritten on the first iteration (the center is in frame).
    dx0 = jnp.zeros((nbh, nbw), jnp.int32)
    dy0 = jnp.zeros((nbh, nbw), jnp.int32)

    neigh_off = jnp.array(
        [(r, c) for r in (-2, 0, 2) for c in (-2, 0, 2)], dtype=jnp.int32
    )  # row-major product([x-2,x,x+2],[y-2,y,y+2])

    def body(state):
        x, y, dx, dy, step, it, touched = state
        s = step
        zero = jnp.zeros_like(s)
        cross = jnp.stack(
            [
                jnp.stack([zero, zero], -1),
                jnp.stack([s, zero], -1),
                jnp.stack([-s, zero], -1),
                jnp.stack([zero, s], -1),
                jnp.stack([zero, -s], -1),
            ],
            axis=-2,
        )  # (nbh, nbw, 5, 2)
        pad = jnp.full((nbh, nbw, 4, 2), jnp.iinfo(jnp.int32).min // 4, jnp.int32)
        cross9 = jnp.concatenate([cross, pad], axis=-2)
        neigh9 = jnp.broadcast_to(neigh_off, (nbh, nbw, 9, 2))
        offs = jnp.where((step == 2)[..., None, None], neigh9, cross9)

        center = jnp.stack([x, y], axis=-1)
        pos = center[..., None, :] + offs  # absolute candidate positions
        valid = _in_frame(pos, bs, H, W)
        cost = evaluate(pos, valid)
        best = _take_best(pos, cost)
        ndx, ndy = best[..., 0], best[..., 1]

        halve = ((ndx == x) & (ndy == y)) | (step == 2)
        nstep = jnp.where(halve, step // 2, step)

        active = step > 1
        # Volume-radius soundness tracking: some candidate this round could
        # read +inf through the radius mask iff the centre's displacement
        # plus the step reaches past the radius (frame clamps only shrink
        # displacements, so they cannot un-flag a walk).
        disp = jnp.maximum(
            jnp.abs(x - origins[..., 0]), jnp.abs(y - origins[..., 1])
        )
        touched = touched | (active & (disp + step > radius))
        x = jnp.where(active, ndx, x)
        y = jnp.where(active, ndy, y)
        dx = jnp.where(active, ndx, dx)
        dy = jnp.where(active, ndy, dy)
        step = jnp.where(active, nstep, step)
        return (x, y, dx, dy, step, it + 1, touched)

    def cond(state):
        x, y, dx, dy, step, it, touched = state
        return jnp.any(step > 1) & (it < max_iters)

    x, y, dx, dy, step, _, touched = lax.while_loop(
        cond, body,
        (x0, y0, dx0, dy0, step0, jnp.int32(0),
         jnp.zeros((nbh, nbw), dtype=bool)),
    )
    # Reference bbme.py:430-431: channel 1 = dx - block_row, 0 = dy - block_col.
    field = jnp.stack(
        [dy - origins[..., 1], dx - origins[..., 0]], axis=-1
    ).astype(jnp.int32)
    if return_diagnostics:
        hits = (
            jnp.sum(touched.astype(jnp.int32))
            if volume_engine
            else jnp.int32(0)  # gather engine walks are unbounded
        )
        return field, {"volume_edge_hits": hits}
    return field


# ---------------------------------------------------------------------------
# Diamond search (reference bbme.py:436-534) — the GME default
# ---------------------------------------------------------------------------

_LDSP = np.array(
    [(0, 0), (2, 0), (1, 1), (0, 2), (-1, 1), (-2, 0), (-1, -1), (0, -2), (1, -1)],
    dtype=np.int32,
)
# SDSP offsets as the reference *applies* them — swapped (offset[1], offset[0])
# (bbme.py:518-521): [(0,0),(1,0),(0,1),(-1,0),(0,-1)] becomes this sequence.
_SDSP = np.array([(0, 0), (0, 1), (1, 0), (0, -1), (-1, 0)], dtype=np.int32)


def diamond_walk(
    evaluate: Evaluator,
    origins: jnp.ndarray,
    H: int,
    W: int,
    block_size: int,
    max_iters: int = 4096,
) -> jnp.ndarray:
    """The diamond walk itself: LDSP loop until every block's center wins,
    then one SDSP pass.  Shared by the full-frame search and the row-band
    (spatially-sharded) path — `origins` carries absolute (global)
    coordinates in either case, so clamps and tie-breaking are identical.

    Returns the best absolute positions, shaped like `origins`.
    """
    bs = block_size
    rmax = H - bs - 1
    cmax = W - bs - 1

    def eval_at(offsets, match):
        pos = match[..., None, :] + offsets  # (..., K, 2)
        pos = jnp.stack(
            [jnp.clip(pos[..., 0], 0, rmax), jnp.clip(pos[..., 1], 0, cmax)],
            axis=-1,
        )
        valid = jnp.ones(pos.shape[:-1], dtype=bool)
        cost = evaluate(pos, valid)
        return _take_best(pos, cost)

    def body(state):
        match, done, it = state
        best = eval_at(_LDSP, match)
        ndone = done | jnp.all(best == match, axis=-1)
        nmatch = jnp.where(done[..., None], match, best)
        return (nmatch, ndone, it + 1)

    def cond(state):
        _, done, it = state
        return jnp.any(~done) & (it < max_iters)

    done0 = jnp.zeros(origins.shape[:-1], dtype=bool)
    match, _, _ = lax.while_loop(cond, body, (origins, done0, jnp.int32(0)))

    return eval_at(_SDSP, match)  # single SDSP pass (bbme.py:515-529)


def _succ_map_packed(
    volume: jnp.ndarray,
    origins: jnp.ndarray,
    H: int,
    W: int,
    block_size: int,
    radius: int,
) -> jnp.ndarray:
    """Packed-minimum successor-map builder — the production path.

    Returns the (lead, D*D) **int8 rank map**: entry [cell, o] is the index
    k into `_LDSP` of the first-minimum LDSP candidate when the walk for
    `cell` sits at volume offset `o`.  The chase (`diamond_walk_volume`)
    decodes ranks back to offsets with the same clamp arithmetic the
    reference applies per candidate (bbme.py:503-504) — storing 1-byte ranks
    instead of 4-byte flat offsets quarters the map's memory footprint, and
    the chase re-reads the whole map every iteration.

    The select-chain builder (`_succ_map_select`) spends ~12 elementwise
    passes over the (cells, D, D) volume per LDSP candidate (boundary
    selects, cost compare, cost select, successor select).  This builder
    cuts the per-candidate work to TWO passes:

    1. Build the clamp-extended volume ONCE: Vext[e] for e in [-(R+2), R+2]^2
       equals V[clip(e, lo, hi)] when the clipped offset lies inside the
       volume, else +inf — the reference's position clamp to [0, dim-bs-1]
       (bbme.py:503-504) and the radius mask folded into one tensor, via a
       row-clamp pass then a column-clamp pass (corners compose exactly).
    2. Pack cost and candidate rank into ONE int32: packed = cost*16 + k.
       DFD costs are integers < 2**24 for block sizes <= 16 (the dispatch
       guard), so the pack is exact and min(packed) implements the strict-<
       first-minimum tie-break in LDSP order (equal costs -> smaller k wins).
       Every LDSP candidate is then a statically shifted slice of the packed
       Vext plus k, and the reduction is a plain jnp.minimum tree.

    Bit-identical to `_succ_map_select` (asserted in
    tests/test_cost_volume.py).
    """
    bs, R = block_size, radius
    D = 2 * R + 1
    lead = origins.shape[:-1]
    nlead = len(lead)
    Vg = volume.reshape(lead + (D, D))
    inf = jnp.float32(jnp.inf)

    lo_r = (-origins[..., 0])[..., None, None]  # (lead, 1, 1)
    hi_r = ((H - bs - 1) - origins[..., 0])[..., None, None]
    lo_c = (-origins[..., 1])[..., None, None]
    hi_c = ((W - bs - 1) - origins[..., 1])[..., None, None]

    E = D + 4
    vpad0 = jnp.pad(
        Vg, [(0, 0)] * nlead + [(2, 2), (2, 2)], constant_values=jnp.inf
    )
    e_r = jnp.arange(E, dtype=jnp.int32).reshape(E, 1) - (R + 2)
    e_c = jnp.arange(E, dtype=jnp.int32).reshape(1, E) - (R + 2)

    # Row clamp: extended rows outside [lo_r, hi_r] read the boundary row
    # (+inf when that boundary itself lies outside the volume).
    def _sel_row(bound):
        oh = (e_r == bound)[..., :, :]  # (lead, E, 1)
        row = jnp.sum(jnp.where(oh, vpad0, 0.0), axis=-2, keepdims=True)
        return jnp.where(jnp.abs(bound) <= R, row, inf)  # (lead, 1, E)

    vr = jnp.where(
        e_r < lo_r,
        _sel_row(lo_r),
        jnp.where(e_r > hi_r, _sel_row(hi_r), vpad0),
    )

    # Column clamp on the row-clamped tensor (corners compose exactly).
    def _sel_col(bound):
        oh = (e_c == bound)[..., :, :]  # (lead, 1, E)
        col = jnp.sum(jnp.where(oh, vr, 0.0), axis=-1, keepdims=True)
        return jnp.where(jnp.abs(bound) <= R, col, inf)  # (lead, E, 1)

    vext = jnp.where(
        e_c < lo_c,
        _sel_col(lo_c),
        jnp.where(e_c > hi_c, _sel_col(hi_c), vr),
    )

    # Pack: costs are exact integers < 2**24 (bs <= 16); +inf saturates to
    # 2**24, above every real cost.  packed = cost*16 + rank < 2**31.
    packed_ext = jnp.minimum(vext, jnp.float32(2**24)).astype(jnp.int32) * 16

    best = None
    for k, (a, b) in enumerate(_LDSP.tolist()):
        cand = (
            lax.slice(
                packed_ext,
                (0,) * nlead + (a + 2, b + 2),
                lead + (a + 2 + D, b + 2 + D),
            )
            + k
        )
        best = cand if best is None else jnp.minimum(best, cand)
    k_best = best & 15
    return k_best.reshape(lead + (D * D,)).astype(jnp.int8)


def _succ_map(volume, origins, H, W, block_size, radius) -> jnp.ndarray:
    """Successor-map dispatch: the packed builder whenever the cost*16+rank
    pack is exact (max DFD = bs^2 * 255^2 must stay below 2**24, i.e.
    bs <= 16 — every reference configuration), else the select builder."""
    if block_size * block_size * 255 * 255 < 2**24:
        return _succ_map_packed(volume, origins, H, W, block_size, radius)
    return _succ_map_select(volume, origins, H, W, block_size, radius)


def _succ_map_select(
    volume: jnp.ndarray,
    origins: jnp.ndarray,
    H: int,
    W: int,
    block_size: int,
    radius: int,
) -> jnp.ndarray:
    """Select-chain successor-map builder: per LDSP candidate, a statically
    shifted view of the volume with the reference's frame clamps folded in
    as per-block saturation to boundary rows/columns (bbme.py:503-504),
    reduced by strict-< first-minimum into the (lead, D*D) int8 rank map
    (see `_succ_map_packed` for the rank-map contract).  Bit-identical to
    `_succ_map_packed` (asserted in tests) — serves as its verification twin
    and as the fallback for block sizes too large for the exact pack."""
    bs, R = block_size, radius
    D = 2 * R + 1
    lead = origins.shape[:-1]
    Vg = volume.reshape(lead + (D, D))
    inf = jnp.float32(jnp.inf)

    g_r = origins[..., 0]
    g_c = origins[..., 1]
    # Frame clamp bounds in offset space (reference bbme.py:503-504 clamps
    # positions to [0, dim - bs - 1]).
    lo_r = -g_r
    hi_r = (H - bs - 1) - g_r
    lo_c = -g_c
    hi_c = (W - bs - 1) - g_c

    def _grid_idx(b):
        return (jnp.clip(b, -R, R) + R).astype(jnp.int32)

    # j-independent boundary slices of the volume (tiny gathers, done once):
    # the row/column a saturated candidate lands on, +inf when that boundary
    # itself lies outside the volume.
    def _bnd_row(b):
        row = jnp.take_along_axis(Vg, _grid_idx(b)[..., None, None], axis=-2)
        row = row[..., 0, :]  # (lead, D)
        return jnp.where((jnp.abs(b) <= R)[..., None], row, inf)

    def _bnd_col(b):
        col = jnp.take_along_axis(Vg, _grid_idx(b)[..., None, None], axis=-1)
        col = col[..., 0]  # (lead, D)
        return jnp.where((jnp.abs(b) <= R)[..., None], col, inf)

    row_lo, row_hi = _bnd_row(lo_r), _bnd_row(hi_r)
    col_lo, col_hi = _bnd_col(lo_c), _bnd_col(hi_c)

    def _corner(row, bc):
        v = jnp.take_along_axis(row, _grid_idx(bc)[..., None], axis=-1)[..., 0]
        return jnp.where(jnp.abs(bc) <= R, v, inf)  # (lead,)

    corners = {
        ("lo", "lo"): _corner(row_lo, lo_c),
        ("lo", "hi"): _corner(row_lo, hi_c),
        ("hi", "lo"): _corner(row_hi, lo_c),
        ("hi", "hi"): _corner(row_hi, hi_c),
    }

    pad = 2  # max |LDSP offset|
    Vpad = jnp.pad(Vg, [(0, 0)] * len(lead) + [(pad, pad), (pad, pad)],
                   constant_values=jnp.inf)
    o_grid = jnp.arange(-R, R + 1, dtype=jnp.int32)

    def _shift1d(x, s):
        """x (lead, D) statically shifted by s along the last axis with +inf
        padding: out[..., i] = x[..., i + s]."""
        xp = jnp.pad(x, [(0, 0)] * len(lead) + [(pad, pad)],
                     constant_values=jnp.inf)
        return lax.slice_in_dim(xp, s + pad, s + pad + D, axis=-1)

    best_cost = None
    best_k = None
    for k, (a, b) in enumerate(_LDSP.tolist()):
        er_raw = o_grid + a  # (D,)
        er = jnp.clip(er_raw, lo_r[..., None], hi_r[..., None])  # (lead, D)
        sat_r = er != er_raw
        in_r = jnp.abs(er) <= R
        below_r = er_raw < lo_r[..., None]
        ec_raw = o_grid + b
        ec = jnp.clip(ec_raw, lo_c[..., None], hi_c[..., None])
        sat_c = ec != ec_raw
        in_c = jnp.abs(ec) <= R
        below_c = ec_raw < lo_c[..., None]

        # Unsaturated value: statically shifted volume view.
        U = lax.slice(
            Vpad,
            (0,) * len(lead) + (a + pad, b + pad),
            lead + (a + pad + D, b + pad + D),
        )
        # Row-saturated: boundary row (lo or hi) shifted along columns by b.
        row_val = jnp.where(
            below_r[..., None], _shift1d(row_lo, b)[..., None, :],
            _shift1d(row_hi, b)[..., None, :],
        )
        # Column-saturated: boundary column shifted along rows by a.
        col_val = jnp.where(
            below_c[..., None, :],
            _shift1d(col_lo, a)[..., :, None],
            _shift1d(col_hi, a)[..., :, None],
        )
        # Corner (both axes saturated).
        c_ll = corners[("lo", "lo")][..., None, None]
        c_lh = corners[("lo", "hi")][..., None, None]
        c_hl = corners[("hi", "lo")][..., None, None]
        c_hh = corners[("hi", "hi")][..., None, None]
        corner_val = jnp.where(
            below_r[..., :, None],
            jnp.where(below_c[..., None, :], c_ll, c_lh),
            jnp.where(below_c[..., None, :], c_hl, c_hh),
        )

        sat_r2 = sat_r[..., :, None]
        sat_c2 = sat_c[..., None, :]
        cost = jnp.where(
            sat_r2 & sat_c2, corner_val,
            jnp.where(sat_r2, row_val, jnp.where(sat_c2, col_val, U)),
        )
        cost = jnp.where(
            (in_r[..., :, None]) & (in_c[..., None, :]), cost, inf
        )

        if best_cost is None:
            best_cost = cost
            best_k = jnp.zeros(cost.shape, jnp.int8)
        else:
            take = cost < best_cost  # strict < == first-minimum tie-break
            best_cost = jnp.where(take, cost, best_cost)
            best_k = jnp.where(take, jnp.int8(k), best_k)

    return best_k.reshape(lead + (D * D,))


def diamond_walk_volume(
    volume: jnp.ndarray,
    origins: jnp.ndarray,
    H: int,
    W: int,
    block_size: int,
    radius: int,
    max_iters: int = 4096,
    with_diagnostics: bool = False,
    count_mask: jnp.ndarray = None,
) -> jnp.ndarray:
    """Volume-engine diamond walk as a dense successor map + pointer chase.

    The lockstep walk's per-iteration cost is dominated by gathering 9 LDSP
    candidate costs per block from the cost volume.  Since every candidate
    cost is just a volume entry at a *statically shifted* offset, the LDSP
    argmin can be precomputed for EVERY offset densely — elementwise work
    over shifted views, no gathers:

        next[block, o] = offset of the first-minimum LDSP candidate at o

    (with the reference's frame clamps folded in as per-block saturation to
    boundary rows/columns of the volume).  The walk then chases successor
    pointers: ONE gathered element per block per iteration instead of nine
    candidate costs, with the exact same trajectory, clamps, and first-min
    tie-breaking as `diamond_walk` — bit-identical results.

    The map is built by `_succ_map` (packed-minimum builder — see
    `_succ_map_packed`), then chased to a fixed point per block.

    Returns the best absolute positions (after the SDSP pass), shaped like
    `origins`.  With ``with_diagnostics=True`` also returns the number of
    walks that ever VISITED the volume's boundary-adjacent ring
    (max |offset| >= R - 1) — the runtime soundness certificate for the
    volume-radius approximation (the reference walk is unbounded within
    frame clamps, bbme.py:494-513).  At an offset with max |o| <= R - 2
    every LDSP candidate (|delta| <= 2, frame clamps only shrink offsets)
    lies inside the volume, so the successor there is identical for ANY
    radius >= R; a walk that never enters the ring therefore follows the
    exact unbounded trajectory, and its SDSP candidates (|delta| <= 1) are
    in-volume too.  Zero count ==> results bit-identical to any larger
    radius (including the escape-triggered full-radius fallback,
    models.gme); a nonzero count flags possibly-clamped blocks.
    """
    bs, R = block_size, radius
    D = 2 * R + 1
    lead = origins.shape[:-1]
    rank_map = _succ_map(volume, origins, H, W, bs, R)  # (lead, D*D) int8
    o0 = jnp.full(lead, R * D + R, jnp.int32)

    # Rank decode: the same per-candidate clamp arithmetic the builders fold
    # into their cost composition (reference bbme.py:503-504), applied to the
    # winning rank only.  lo/hi are per-cell frame-clamp bounds in offset
    # space; rank 0 decodes to clip(o, lo, hi) == o for any reachable o.
    lo_r = -origins[..., 0]
    hi_r = (H - bs - 1) - origins[..., 0]
    lo_c = -origins[..., 1]
    hi_c = (W - bs - 1) - origins[..., 1]

    ldsp_a = jnp.asarray(_LDSP[:, 0])
    ldsp_b = jnp.asarray(_LDSP[:, 1])

    # The chase reads ONE map entry per cell per iteration, as a masked
    # one-hot sum: a fused compare+select+reduce sweep over the map.
    # Exact: exactly one lane matches o.
    o_iota = jax.lax.broadcasted_iota(jnp.int32, lead + (D * D,), len(lead))

    def _rank_at(o):
        hit = o[..., None] == o_iota
        return jnp.sum(
            jnp.where(hit, rank_map, jnp.int8(0)).astype(jnp.int32), axis=-1
        )

    def body(state):
        o, _, it, touched = state
        # Soundness tracking: the successor consulted at `o` could differ
        # from a larger-radius map only when o sits in the boundary-adjacent
        # ring (see docstring) — OR over every visited offset.
        omax = jnp.maximum(jnp.abs(o // D - R), jnp.abs(o % D - R))
        touched = touched | (omax >= R - 1)
        k = _rank_at(o)
        a = jnp.take(ldsp_a, k)
        b = jnp.take(ldsp_b, k)
        er = jnp.clip(o // D - R + a, lo_r, hi_r)
        ec = jnp.clip(o % D - R + b, lo_c, hi_c)
        nxt = (er + R) * D + (ec + R)
        return (nxt, jnp.any(nxt != o), it + 1, touched)

    def cond(state):
        _, changed, it, _ = state
        return changed & (it < max_iters)

    o, _, _, touched = lax.while_loop(
        cond, body,
        (o0, jnp.bool_(True), jnp.int32(0), jnp.zeros(lead, dtype=bool)),
    )

    match = jnp.stack(
        [origins[..., 0] + o // D - R, origins[..., 1] + o % D - R], axis=-1
    )
    if with_diagnostics:
        edge = touched
        if count_mask is not None:
            edge = edge & count_mask
        edge_hits = jnp.sum(edge.astype(jnp.int32))

    # Single SDSP pass (bbme.py:515-529) through the ordinary evaluator.
    evaluate = volume_evaluator(volume, origins, R)
    rmax = H - bs - 1
    cmax = W - bs - 1
    pos = match[..., None, :] + _SDSP
    pos = jnp.stack(
        [jnp.clip(pos[..., 0], 0, rmax), jnp.clip(pos[..., 1], 0, cmax)],
        axis=-1,
    )
    cost = evaluate(pos, jnp.ones(pos.shape[:-1], dtype=bool))
    best = _take_best(pos, cost)
    if with_diagnostics:
        return best, edge_hits
    return best


def diamond_search(
    previous: jnp.ndarray,
    current: jnp.ndarray,
    pnorm_distance: int = MAE,
    block_size: int = 12,
    search_window: int = -1,
    max_iters: int = 4096,
    search_impl: str = "auto",
    volume_radius: int = 32,
    return_diagnostics: bool = False,
) -> jnp.ndarray:
    """Large-diamond loop until the center wins, then one small-diamond pass.

    Candidate positions are clamped to [0, dim - bs - 1] exactly as the
    reference does (bbme.py:503-504, 522-523) — including the off-by-one that
    keeps candidates one pixel short of the frame edge, which also shifts the
    *center* candidate of blocks in the last row/column.  `search_window` is
    accepted for API parity and ignored (the reference ignores it too).

    The volume engine uses the dense-successor-map walk
    (`diamond_walk_volume`); the gather engine uses the direct lockstep walk.
    Both are bit-identical (asserted in tests).
    """
    del search_window
    H, W = previous.shape
    bs = block_size
    nbh, nbw = _block_grid(H, W, bs)
    origins = _block_origins(nbh, nbw, bs)

    edge_hits = jnp.int32(0)  # gather engine walks are unbounded — no clamp
    if _resolve_impl(search_impl) == "volume":
        radius = min(volume_radius, max(H, W))
        volume = compute_cost_volume(previous, current, bs, radius,
                                     pnorm_distance)
        best, edge_hits = diamond_walk_volume(
            volume, origins, H, W, bs, radius, max_iters,
            with_diagnostics=True,
        )
    else:
        evaluate = _make_gather_evaluator(previous, current, bs,
                                          pnorm_distance)
        best = diamond_walk(evaluate, origins, H, W, bs, max_iters)

    # Reference bbme.py:531-532: ch1 = row shift, ch0 = col shift.
    field = jnp.stack(
        [best[..., 1] - origins[..., 1], best[..., 0] - origins[..., 0]], axis=-1
    ).astype(jnp.int32)
    if return_diagnostics:
        return field, {"volume_edge_hits": edge_hits}
    return field


# ---------------------------------------------------------------------------
# Dispatch — behavioural API of reference bbme.py:12-38, 608-614
# ---------------------------------------------------------------------------

def get_motion_field(
    previous: jnp.ndarray,
    current: jnp.ndarray,
    block_size: int = 4,
    search_window: int = 2,
    searching_procedure: int = THREESTEP,
    pnorm_distance: int = MSE,
    max_iters: int = 4096,
    search_impl: str = "auto",
    volume_radius: int = 32,
    return_diagnostics: bool = False,
) -> jnp.ndarray:
    """Compute the (H//bs, W//bs, 2) int32 motion field between two frames.

    Signature and defaults mirror reference bbme.py:12-19; procedure indices
    {0: exhaustive, 1: three-step, 2: 2D-log, 3: diamond} mirror the
    reference dispatch table (bbme.py:609-614).

    With ``return_diagnostics=True`` also returns a dict of runtime parity
    diagnostics: ``volume_edge_hits`` counts volume-engine walks whose
    trajectory a larger radius could have changed — diamond walks that
    entered the boundary-adjacent ring (diamond_walk_volume) and 2D-log
    walks whose displacement plus step reached the radius (twodlog_search).
    Zero for searches whose displacement is statically bounded
    (exhaustive / three-step) and for the unbounded gather engine.
    """
    if searching_procedure == EXHAUSTIVE:
        field = exhaustive_search(
            previous, current, pnorm_distance, block_size, search_window
        )
    elif searching_procedure == THREESTEP:
        field = threestep_search(
            previous, current, pnorm_distance, block_size, search_window,
            search_impl,
        )
    elif searching_procedure == TWODLOG:
        if return_diagnostics:
            return twodlog_search(
                previous, current, pnorm_distance, block_size, search_window,
                max_iters, search_impl, volume_radius,
                return_diagnostics=True,
            )
        field = twodlog_search(
            previous, current, pnorm_distance, block_size, search_window,
            max_iters, search_impl, volume_radius,
        )
    elif searching_procedure == DIAMOND:
        if return_diagnostics:
            return diamond_search(
                previous, current, pnorm_distance, block_size, search_window,
                max_iters, search_impl, volume_radius,
                return_diagnostics=True,
            )
        field = diamond_search(
            previous, current, pnorm_distance, block_size, search_window,
            max_iters, search_impl, volume_radius,
        )
    else:
        raise ValueError(f"unknown searching procedure {searching_procedure}")
    if return_diagnostics:
        return field, {"volume_edge_hits": jnp.int32(0)}
    return field


@partial(
    jax.jit,
    static_argnames=(
        "block_size",
        "search_window",
        "searching_procedure",
        "pnorm_distance",
        "max_iters",
        "search_impl",
        "volume_radius",
    ),
)
def get_motion_field_jit(
    previous,
    current,
    block_size: int = 4,
    search_window: int = 2,
    searching_procedure: int = THREESTEP,
    pnorm_distance: int = MSE,
    max_iters: int = 4096,
    search_impl: str = "auto",
    volume_radius: int = 32,
):
    return get_motion_field(
        previous,
        current,
        block_size,
        search_window,
        searching_procedure,
        pnorm_distance,
        max_iters,
        search_impl,
        volume_radius,
    )


def get_motion_field_cfg(previous, current, cfg: BBMEConfig) -> jnp.ndarray:
    return get_motion_field(
        previous,
        current,
        cfg.block_size,
        cfg.search_window,
        cfg.searching_procedure,
        cfg.pnorm_distance,
        cfg.max_search_iters,
        cfg.search_impl,
        cfg.volume_radius,
    )
