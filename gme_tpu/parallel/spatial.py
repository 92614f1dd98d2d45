"""Spatial (row-band) parallelism with halo exchange — the framework's
sequence-parallel analogue, running the FULL flagship model.

A frame's rows shard over the mesh "space" axis and stay sharded through the
whole hierarchical robust GME (reference motion.py:109-136):

- Gaussian pyramids are built on the row bands directly, with a 2-row halo
  exchange per level (`lax.ppermute`) and the cv2.pyrDown REFLECT_101 border
  applied only at the global frame edges — bit-exact with the full-frame
  `ops.pyramid.pyrdown`.
- Per pyramid level, each device computes the DFD cost volume only for its
  own block rows (the op carrying ~all the FLOPs), from its local
  previous-frame band plus `volume_radius + block`-row halos of the current
  frame — the halo-exchange design point of BASELINE.json:5.  The diamond
  walk (reference bbme.py:436-534, the GME default) then runs on the local
  band with global coordinates, reusing the exact same walk code as the
  single-device path (`ops.bbme.diamond_walk`).
- The 30% outlier rejection (reference motion.py:236-244) needs a global
  sort of per-cell errors: the (tiny) error grid is `all_gather`ed and every
  device computes the identical threshold.
- The affine fit's normal equations reduce with one `lax.psum`
  (reference math: motion.py:52-84), so every device holds identical
  parameters by construction — the moral equivalent of a DP gradient
  all-reduce.
- Compensation runs per row band against the `all_gather`ed previous frame
  (displacements are unbounded, reference motion.py:289-321); PSNR's SSE is
  `psum`med.

The searches use the cost-volume engine (`search_impl="volume"`,
bit-identical to the gather engine for walks within `volume_radius`): a
band's volume needs only a bounded halo of the current frame, where the
gather walk's unbounded wander would not.  Single-device comparisons
should force the same engine.

The reference has no parallelism whatsoever (SURVEY.md §2.2) — this design
comes from the north-star spec, not from reference code.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from gme_tpu.config import DIAMOND, EXHAUSTIVE, THREESTEP, GMEConfig
from gme_tpu.ops.affine import (
    get_motion_field_affine,
    int_moments,
    moments_fit_ok,
    parameter_projection,
    params_from_moments,
)
from gme_tpu.ops.bbme import (
    _INF,
    _block_grid,
    _cost_volume_core,
    compute_cost_volume_band,
    diamond_walk_volume,
    threestep_search_radius,
    threestep_walk,
    volume_evaluator,
)
from gme_tpu.parallel.mesh import DATA_AXIS, SPACE_AXIS

_W5 = (1.0, 4.0, 6.0, 4.0, 1.0)  # cv2.pyrDown binomial taps (ops/pyramid.py)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------

def extend_rows(
    x: jnp.ndarray, top: int, bottom: int, axis_name: str, space: int
) -> jnp.ndarray:
    """Extend a row band with `top`/`bottom` rows from its neighbours.

    Multi-hop `lax.ppermute` halo exchange: when the halo is wider than one
    band, successive hops pull rows from farther neighbours.  Rows beyond
    the global frame come back as zeros (ppermute edge semantics) — callers
    mask them (out-of-frame candidates are invalid; pyramid edges get the
    REFLECT_101 fix-up in `_pyrdown_band`).
    """
    lh = x.shape[0]
    tops: List[jnp.ndarray] = []
    bots: List[jnp.ndarray] = []
    hops_t = -(-top // lh) if top > 0 else 0
    for h in range(hops_t, 0, -1):  # farthest neighbour first
        nb = lax.ppermute(
            x, axis_name, [(i, i + h) for i in range(space - h)]
        )  # the band h shards above mine
        take = min(top - (h - 1) * lh, lh)
        tops.append(nb[lh - take :])
    hops_b = -(-bottom // lh) if bottom > 0 else 0
    for h in range(1, hops_b + 1):
        nb = lax.ppermute(x, axis_name, [(i + h, i) for i in range(space - h)])
        take = min(bottom - (h - 1) * lh, lh)
        bots.append(nb[:take])
    if not tops and not bots:
        return x
    return jnp.concatenate(tops + [x] + bots, axis=0)


# ---------------------------------------------------------------------------
# Gaussian pyramid on row bands (bit-exact with ops.pyramid.pyrdown)
# ---------------------------------------------------------------------------

def _pyrdown_band(band: jnp.ndarray, axis_name: str, space: int) -> jnp.ndarray:
    """One cv2.pyrDown level on a row band: 2-row halo exchange + the
    REFLECT_101 border applied only at the global top/bottom edges.

    Requires the local band height to be even (the driver validates
    H % (space * 2**(levels-1)) == 0).
    """
    lh, W = band.shape
    x = band.astype(jnp.float32)
    ext = extend_rows(x, 2, 2, axis_name, space)  # (lh + 4, W)
    idx = lax.axis_index(axis_name)
    # Global REFLECT_101: rows -1,-2 -> 1,2; rows H,H+1 -> H-2,H-3.
    top_fix = jnp.stack([x[2], x[1]])
    bot_fix = jnp.stack([x[lh - 2], x[lh - 3]])
    ext = ext.at[0:2].set(jnp.where(idx == 0, top_fix, ext[0:2]))
    ext = ext.at[lh + 2 : lh + 4].set(
        jnp.where(idx == space - 1, bot_fix, ext[lh + 2 : lh + 4])
    )
    ext = jnp.pad(ext, ((0, 0), (2, 2)), mode="reflect")  # columns: local
    oh, ow = lh // 2, (W + 1) // 2
    v = sum(w * ext[k : k + 2 * oh - 1 : 2, :] for k, w in enumerate(_W5))
    acc = sum(w * v[:, k : k + 2 * ow - 1 : 2] for k, w in enumerate(_W5))
    return jnp.floor((acc + 128.0) * (1.0 / 256.0)).astype(jnp.uint8)


def _pyramids_band(
    band: jnp.ndarray, levels: int, axis_name: str, space: int
) -> List[jnp.ndarray]:
    """Banded Gaussian pyramid, coarsest-first (reference utils.py:34-51)."""
    pyramid = [band]
    curr = band
    for _ in range(1, levels):
        curr = _pyrdown_band(curr, axis_name, space)
        pyramid.insert(0, curr)
    return pyramid


# ---------------------------------------------------------------------------
# Banded block matching (diamond search over a local cost volume)
# ---------------------------------------------------------------------------

def _band_tmax(H: int, space: int, bs: int) -> int:
    """Max block rows owned by any shard (a shard owns block rows whose
    origin falls inside its pixel band)."""
    lh, nbh = H // space, H // bs
    counts = []
    for k in range(space):
        gb0 = -(-(k * lh) // bs)
        gb1 = min(-(-((k + 1) * lh) // bs), nbh)
        counts.append(max(gb1 - gb0, 0))
    return max(counts)


def _banded_volume(
    prev_band: jnp.ndarray,
    curr_band: jnp.ndarray,
    H: int,
    W: int,
    bs: int,
    R: int,
    pnorm: int,
    axis_name: str,
    space: int,
):
    """Shared banded cost-volume builder: halo-exchange the current frame by
    the search radius, compute this shard's block rows' masked DFD volume,
    and return (vol (Tmax, nbw, D*D), origins (Tmax, nbw, 2) global coords,
    valid_t (Tmax,), gb0).  Backs the banded diamond AND three-step walks —
    both then reuse the exact single-device walk code on global coordinates.
    """
    lh = prev_band.shape[0]
    nbh, nbw = _block_grid(H, W, bs)
    Tmax = _band_tmax(H, space, bs)

    k = lax.axis_index(axis_name)
    gb0 = (k * lh + bs - 1) // bs
    gb1 = jnp.minimum(((k + 1) * lh + bs - 1) // bs, nbh)
    valid_t = gb0 + jnp.arange(Tmax, dtype=jnp.int32) < gb1

    # Previous-frame rows [gb0*bs, (gb0+Tmax)*bs): the band plus up to
    # (bs-1) + Tmax*bs - lh rows from below.
    ext_b = max(0, Tmax * bs + bs - 1 - lh)
    prev_f = prev_band[:, : nbw * bs].astype(jnp.float32)
    prev_ext = extend_rows(prev_f, 0, ext_b, axis_name, space)
    start = gb0 * bs - k * lh  # in [0, bs)
    prev_blk = lax.dynamic_slice(prev_ext, (start, 0), (Tmax * bs, nbw * bs))

    # Current-frame rows [gb0*bs - R, (gb0+Tmax)*bs + R): halo exchange of
    # R above and ext_b + R below (BASELINE.json:5's search-window halos).
    curr_f = curr_band.astype(jnp.float32)
    curr_ext = extend_rows(curr_f, R, ext_b + R, axis_name, space)
    curr_ext = jnp.pad(curr_ext, ((0, 0), (R, R)))[:, : nbw * bs + 2 * R]
    curr_blk = lax.dynamic_slice(
        curr_ext, (start, 0), (Tmax * bs + 2 * R, nbw * bs + 2 * R)
    )

    vol = compute_cost_volume_band(
        prev_blk, curr_blk, gb0, (H, W), bs, R, pnorm
    )  # (Tmax, nbw, D*D), +inf outside the global frame

    gi = (gb0 + jnp.arange(Tmax, dtype=jnp.int32))[:, None] * bs
    gj = (jnp.arange(nbw, dtype=jnp.int32) * bs)[None, :]
    origins = jnp.stack(
        [jnp.broadcast_to(gi, (Tmax, nbw)), jnp.broadcast_to(gj, (Tmax, nbw))],
        axis=-1,
    )
    return vol, origins, valid_t, gb0


def banded_diamond_field(
    prev_band: jnp.ndarray,
    curr_band: jnp.ndarray,
    H: int,
    W: int,
    bs: int,
    radius: int,
    pnorm: int,
    max_iters: int,
    axis_name: str,
    space: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Diamond-search motion field for this shard's block rows.

    Returns (field (Tmax, nbw, 2) int32, valid (Tmax,) bool, gb0 scalar,
    edge_hits scalar int32 — this shard's count of walks that entered the
    volume's boundary-adjacent ring, masked to valid rows; see
    bbme.diamond_walk_volume).  Channel conventions and walk semantics
    identical to the single-device `diamond_search` (volume engine).
    """
    vol, origins, valid_t, gb0 = _banded_volume(
        prev_band, curr_band, H, W, bs, radius, pnorm, axis_name, space
    )
    Tmax, nbw = origins.shape[:2]
    best, edge_hits = diamond_walk_volume(
        vol, origins, H, W, bs, radius, max_iters,
        with_diagnostics=True,
        count_mask=jnp.broadcast_to(valid_t[:, None], (Tmax, nbw)),
    )

    field = jnp.stack(
        [best[..., 1] - origins[..., 1], best[..., 0] - origins[..., 0]],
        axis=-1,
    ).astype(jnp.int32)
    return field, valid_t, gb0, edge_hits


def banded_threestep_field(
    prev_band: jnp.ndarray,
    curr_band: jnp.ndarray,
    H: int,
    W: int,
    bs: int,
    sw: int,
    pnorm: int,
    axis_name: str,
    space: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Three-step-search motion field for this shard's block rows.

    Three-step's displacement is statically bounded (every evaluated
    position lies within `threestep_search_radius(bs, sw)` of the block
    origin — reference bbme.py:211-213, 260-301), so it fits the banded
    volume machinery directly: build the local volume at the exact radius,
    then run the single-device rounds (`bbme.threestep_walk`) on global
    coordinates.  Bit-identical to `ops.bbme.threestep_search`
    (tests/test_parallel.py); returns the `banded_diamond_field` contract
    with edge_hits=0 (the exact radius makes escapes impossible).
    """
    R = threestep_search_radius(bs, sw)
    vol, origins, valid_t, gb0 = _banded_volume(
        prev_band, curr_band, H, W, bs, R, pnorm, axis_name, space
    )
    d = threestep_walk(
        volume_evaluator(vol, origins, R), origins, H, W, bs, sw
    )
    # Channel 0 = dy (col), channel 1 = dx (row) — reference bbme.py:338-339.
    field = jnp.stack([d[..., 1], d[..., 0]], axis=-1).astype(jnp.int32)
    return field, valid_t, gb0, jnp.int32(0)


def banded_exhaustive_field(
    prev_band: jnp.ndarray,
    curr_band: jnp.ndarray,
    H: int,
    W: int,
    bs: int,
    sw: int,
    pnorm: int,
    axis_name: str,
    space: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exhaustive-search motion field for this shard's block rows: the same
    banded cost volume as the diamond path, plus a masked first-minimum
    argmin instead of a walk (reference bbme.py:105-179 — candidate offsets
    span the asymmetric ``range(-sw, sw + bs)`` window, scan order
    window_col outer / window_row inner fixes tie-breaking, out-of-frame
    candidates are skipped).  Bit-identical to the single-device
    `ops.bbme.exhaustive_search` (tests/test_parallel.py).

    Returns (field, valid_t, gb0, edge_hits=0) — the same contract as
    `banded_diamond_field` (exhaustive displacement is statically bounded,
    so the radius-escape diagnostic is always zero).
    """
    lh = prev_band.shape[0]
    nbh, nbw = _block_grid(H, W, bs)
    D = 2 * sw + bs
    Tmax = _band_tmax(H, space, bs)

    k = lax.axis_index(axis_name)
    gb0 = (k * lh + bs - 1) // bs
    gb1 = jnp.minimum(((k + 1) * lh + bs - 1) // bs, nbh)
    valid_t = gb0 + jnp.arange(Tmax, dtype=jnp.int32) < gb1

    ext_b = max(0, Tmax * bs + bs - 1 - lh)
    prev_f = prev_band[:, : nbw * bs].astype(jnp.float32)
    prev_ext = extend_rows(prev_f, 0, ext_b, axis_name, space)
    start = gb0 * bs - k * lh  # in [0, bs)
    prev_blk = lax.dynamic_slice(prev_ext, (start, 0), (Tmax * bs, nbw * bs))

    # Window rows for offset index i span [gb0*bs - sw, (gb0+Tmax)*bs + sw
    # + bs - 1): halo-exchange sw above and ext_b + sw + bs - 1 below.
    curr_f = curr_band.astype(jnp.float32)
    curr_ext = extend_rows(curr_f, sw, ext_b + sw + bs - 1, axis_name, space)
    curr_ext = jnp.pad(curr_ext, ((0, 0), (sw, sw + bs - 1)))[
        :, : nbw * bs + D - 1
    ]
    curr_blk = lax.dynamic_slice(
        curr_ext, (start, 0), (Tmax * bs + D - 1, nbw * bs + D - 1)
    )

    vol = _cost_volume_core(prev_blk, curr_blk, bs, D, pnorm)  # (Dr, Dc, T, nbw)
    offsets = jnp.arange(-sw, sw + bs, dtype=jnp.int32)
    row0 = (gb0 + jnp.arange(Tmax, dtype=jnp.int32)) * bs
    col0 = jnp.arange(nbw, dtype=jnp.int32) * bs
    valid_r = (row0[None, :] + offsets[:, None] >= 0) & (
        row0[None, :] + offsets[:, None] + bs - 1 <= H - 1
    )  # (D, T)
    valid_c = (col0[None, :] + offsets[:, None] >= 0) & (
        col0[None, :] + offsets[:, None] + bs - 1 <= W - 1
    )  # (D, nbw)
    # (D_wc, D_wr, T, nbw): window_col is the reference's outer loop.
    cost = vol.transpose(1, 0, 2, 3)
    mask = valid_c[:, None, None, :] & valid_r[None, :, :, None]
    cost = jnp.where(mask, cost, _INF)

    flat = cost.reshape(D * D, Tmax, nbw)
    kk = jnp.argmin(flat, axis=0)  # first minimum == strict-< scan order
    dy = offsets[kk // D]  # window_col -> channel 0 (x/col shift)
    dx = offsets[kk % D]  # window_row -> channel 1 (y/row shift)
    field = jnp.stack([dy, dx], axis=-1).astype(jnp.int32)
    return field, valid_t, gb0, jnp.int32(0)


def _banded_field(
    prev_band, curr_band, H, W, bs, radius, cfg: GMEConfig, axis_name, space
):
    """Search-procedure dispatch for the banded motion field (the GME
    default is diamond, reference motion.py:29,50,229; exhaustive and
    three-step use `cfg.search_window`, whose default 2 matches
    `get_motion_field`'s signature default, reference bbme.py:12-19 — the
    GME path never overrides it)."""
    if cfg.searching_procedure == DIAMOND:
        return banded_diamond_field(
            prev_band, curr_band, H, W, bs, radius, cfg.pnorm_distance,
            cfg.max_search_iters, axis_name, space,
        )
    if cfg.searching_procedure == EXHAUSTIVE:
        return banded_exhaustive_field(
            prev_band, curr_band, H, W, bs, cfg.search_window,
            cfg.pnorm_distance, axis_name, space,
        )
    if cfg.searching_procedure == THREESTEP:
        return banded_threestep_field(
            prev_band, curr_band, H, W, bs, cfg.search_window,
            cfg.pnorm_distance, axis_name, space,
        )
    raise ValueError(
        "spatially-sharded pipeline supports diamond, exhaustive and "
        "three-step search"
    )


# ---------------------------------------------------------------------------
# Distributed affine fit (psum'd normal equations + gathered outlier sort)
# ---------------------------------------------------------------------------

def _first_params_psum(
    field: jnp.ndarray, valid_t: jnp.ndarray, axis_name: str
) -> jnp.ndarray:
    """Translation-only init: a0/b0 = global mean of the dense field
    (reference motion.py:160-188), reduced with one psum."""
    m = valid_t[:, None].astype(jnp.float32)
    sums = jnp.stack(
        [
            jnp.sum(field[..., 0].astype(jnp.float32) * m),
            jnp.sum(field[..., 1].astype(jnp.float32) * m),
            jnp.sum(m) * field.shape[1],
        ]
    )
    sums = lax.psum(sums, axis_name)
    a0 = sums[0] / sums[2]
    b0 = sums[1] / sums[2]
    z = jnp.float32(0)
    return jnp.stack([a0, z, z, b0, z, z])


def _fit_psum(
    field: jnp.ndarray,
    inlier: jnp.ndarray,
    gb0: jnp.ndarray,
    frame_shape: Tuple[int, int],
    coord_stride: int,
    axis_name: str,
) -> jnp.ndarray:
    """Distributed LS affine fit: each shard contributes exact int32 moment
    partials (`ops.affine.int_moments` with global block-row coordinates),
    ONE `lax.psum` reduces them, and every shard solves the identical
    closed-form system.  Integer summation is order-independent, so the
    result is BIT-IDENTICAL to the single-device `fit_normal_equations` —
    no reduction-order drift (reference math: motion.py:52-84).

    Args:
        field: (Tmax, nbw, 2) local int motion-field band.
        inlier: (Tmax, nbw) bool cell mask (inliers & valid rows).
        gb0: global block row of band row 0.
    """
    moments = int_moments(field, inlier, coord_stride, row0=gb0)
    moments = lax.psum(moments, axis_name)
    return params_from_moments(moments)


def _outlier_inliers(
    field: jnp.ndarray,
    affine_band: jnp.ndarray,
    valid_t: jnp.ndarray,
    outlier_fraction: float,
    n_cells: int,
    axis_name: str,
) -> jnp.ndarray:
    """Distributed 30% outlier rejection (reference motion.py:236-244).

    Per-cell L1 error between the BBME band and the affine band; the (tiny)
    error grid is all_gathered so every shard computes the identical
    threshold — including the reference's `all_diffs[-int(.3N)]` indexing
    quirk (`[-0]` degenerates to `[0]`).  Returns the local INLIER mask.
    """
    diff = jnp.abs(
        field.astype(jnp.int32) - affine_band.astype(jnp.int32)
    ).sum(axis=2)
    errs = jnp.where(valid_t[:, None], diff.astype(jnp.float32), jnp.inf)
    all_errs = lax.all_gather(errs, axis_name)  # (space, Tmax, nbw)
    flat = jnp.sort(all_errs.reshape(-1))  # real cells first, +inf last
    threshold_index = int(outlier_fraction * n_cells)
    threshold = flat[(n_cells - threshold_index) % n_cells]
    return ~(diff.astype(jnp.float32) > threshold)


def _affine_band(
    parameters: jnp.ndarray, nbh: int, nbw: int, Tmax: int, gb0: jnp.ndarray
) -> jnp.ndarray:
    """Rows [gb0, gb0+Tmax) of the dense affine field (the full field is
    tiny, so it is computed replicated and sliced)."""
    full = get_motion_field_affine((nbh, nbw), parameters)
    padded = jnp.pad(full, ((0, Tmax), (0, 0), (0, 0)))
    return lax.dynamic_slice(padded, (gb0, 0, 0), (Tmax, nbw, 2))


# ---------------------------------------------------------------------------
# The full spatially-sharded per-pair step
# ---------------------------------------------------------------------------

def spatial_gme_step(
    prev_band: jnp.ndarray,
    curr_band: jnp.ndarray,
    cfg: GMEConfig,
    H: int,
    W: int,
    axis_name: str = SPACE_AXIS,
    space: int = 1,
) -> Dict[str, jnp.ndarray]:
    """One full pipeline step on row bands — the spatially-sharded twin of
    `models.gme.gme_pipeline_step` (same outputs, same model: 3-level
    pyramid, dense diamond init, per-level robust re-fit, dense affine
    field, compensation, diffs, PSNR; reference motion.py:109-136 +
    results.py:47-110)."""
    levels = cfg.pyramid_levels
    # Per-level global shapes, coarsest first (pyrDown: (n+1)//2).
    Hs, Ws = [H], [W]
    for _ in range(1, levels):
        Hs.insert(0, Hs[0] // 2)
        Ws.insert(0, (Ws[0] + 1) // 2)

    prev_pyr = _pyramids_band(prev_band, levels, axis_name, space)
    curr_pyr = _pyramids_band(curr_band, levels, axis_name, space)

    # Dense translation-only init at the coarsest level (motion.py:13-30,
    # 160-188): block-2 diamond search.
    dense_field, dvalid, _, edge_hits = _banded_field(
        prev_pyr[0], curr_pyr[0], Hs[0], Ws[0],
        cfg.dense_block_size, cfg.dense_volume_radius, cfg, axis_name, space,
    )
    parameters = _first_params_psum(dense_field, dvalid, axis_name)

    # Per finer level: project params, robust re-fit (motion.py:132-134).
    for i in range(1, levels):
        parameters = parameter_projection(parameters)
        nbh, nbw = _block_grid(Hs[i], Ws[i], cfg.block_size)
        field, valid_t, gb0, ehits = _banded_field(
            prev_pyr[i], curr_pyr[i], Hs[i], Ws[i],
            cfg.block_size, cfg.volume_radius, cfg, axis_name, space,
        )
        edge_hits = edge_hits + ehits
        Tmax = field.shape[0]
        aff = _affine_band(parameters, nbh, nbw, Tmax, gb0)
        inlier = _outlier_inliers(
            field, aff, valid_t, cfg.outlier_fraction, nbh * nbw, axis_name
        )
        parameters = _fit_psum(
            field, inlier & valid_t[:, None], gb0,
            (Hs[i], Ws[i]), cfg.coord_stride, axis_name,
        )

    # Dense affine field at (H//bs, W//bs) (results.py:52-54), replicated —
    # it is tiny and every shard derives it from the identical parameters.
    bs = cfg.block_size
    nbh_f, nbw_f = _block_grid(H, W, bs)
    model_motion_field = get_motion_field_affine((nbh_f, nbw_f), parameters)

    # Compensation of the local row band (reference motion.py:289-321
    # semantics: OOB and uncovered pixels keep the original value).  The
    # previous frame is all_gathered — model displacements are unbounded.
    lh = prev_band.shape[0]
    k = lax.axis_index(axis_name)
    row0 = k * lh
    prev_full = lax.all_gather(prev_band, axis_name, axis=0, tiled=True)
    warp_bs = H // nbh_f  # reference motion.py:303 derives bs from the ratio
    rr = row0 + jnp.arange(lh, dtype=jnp.int32)[:, None]
    cc = jnp.arange(W, dtype=jnp.int32)[None, :]
    d = model_motion_field.astype(jnp.int32)
    d_px = d[
        jnp.clip(rr // warp_bs, 0, nbh_f - 1),
        jnp.clip(cc // warp_bs, 0, nbw_f - 1),
    ]
    covered = (rr < nbh_f * warp_bs) & (cc < nbw_f * warp_bs)
    src_r = rr - d_px[..., 1]
    src_c = cc - d_px[..., 0]
    valid = covered & (src_r >= 0) & (src_c >= 0) & (src_r < H) & (src_c < W)
    warped = prev_full[jnp.clip(src_r, 0, H - 1), jnp.clip(src_c, 0, W - 1)]
    compensated = jnp.where(valid, warped, prev_band)

    diff_cp = jnp.abs(
        curr_band.astype(jnp.int32) - prev_band.astype(jnp.int32)
    ).astype(jnp.uint8)
    diff_cc = jnp.abs(
        curr_band.astype(jnp.int32) - compensated.astype(jnp.int32)
    ).astype(jnp.uint8)

    err = curr_band.astype(jnp.float32) - compensated.astype(jnp.float32)
    sse = lax.psum(jnp.sum(err * err), axis_name)
    mse = sse / (H * W)
    psnr_val = jnp.where(
        mse == 0,
        jnp.float32(-1.0),
        (20.0 * jnp.log10(255.0 / jnp.sqrt(mse))).astype(jnp.float32),
    )

    return {
        "parameters": parameters,
        "model_motion_field": model_motion_field,
        "compensated": compensated,
        "diff_curr_prev": diff_cp,
        "diff_curr_comp": diff_cc,
        "psnr": psnr_val,
        # Total across shards (the per-shard counts are disjoint by
        # construction: count_mask restricts to owned block rows).
        "volume_edge_hits": lax.psum(edge_hits, axis_name),
    }


def validate_spatial_shapes(
    H: int, space: int, cfg: GMEConfig, W: int | None = None
) -> None:
    """Shape constraints for the spatially-sharded pipeline."""
    div = space * 2 ** (cfg.pyramid_levels - 1)
    if H % div:
        raise ValueError(
            f"H={H} must be divisible by space * 2**(levels-1) = {div} "
            f"for the spatially-sharded pipeline"
        )
    if H // (space * 2 ** (cfg.pyramid_levels - 1)) < 4:
        raise ValueError(
            f"coarsest-level bands need >= 4 rows "
            f"(H={H}, space={space}, levels={cfg.pyramid_levels})"
        )
    if cfg.searching_procedure not in (DIAMOND, EXHAUSTIVE, THREESTEP):
        raise ValueError(
            "the spatially-sharded pipeline implements diamond (the GME "
            "default, reference motion.py:29,50,229), exhaustive and "
            "three-step search; 2D-log's walk is unbounded within frame "
            "clamps (reference bbme.py:381) so its halo width has no "
            "static bound — single-device only"
        )
    if W is not None:
        # `_fit_psum` always takes the exact int32 moment path; apply the
        # same static overflow bound the single-device `fit_normal_equations`
        # checks (worst case is the finest level: the full frame).
        nbh, nbw = _block_grid(H, W, cfg.block_size)
        if not moments_fit_ok(nbh, nbw, (H, W), cfg.coord_stride):
            raise ValueError(
                f"frame {H}x{W} exceeds the exact int32 moment bound of the "
                "distributed affine fit (moments_fit_ok); use the "
                "single-device pipeline or a larger block size"
            )


def make_spatial_pipeline(mesh: Mesh, cfg: GMEConfig, H: int, W: int):
    """Build the fully-sharded step: pairs over "data", frame rows over
    "space", running the complete hierarchical robust GME per pair.

    Returns a jitted step: (prev (B,H,W) u8, curr (B,H,W) u8) -> dict with
    the same keys as `gme_pipeline_step`, where B % data == 0 and the row
    axis shards over space.
    """
    space = mesh.shape[SPACE_AXIS]
    validate_spatial_shapes(H, space, cfg, W)

    def pair_step(prev_loc, curr_loc):
        return spatial_gme_step(
            prev_loc, curr_loc, cfg, H, W, SPACE_AXIS, space
        )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, SPACE_AXIS, None), P(DATA_AXIS, SPACE_AXIS, None)),
        out_specs={
            "parameters": P(DATA_AXIS),
            "model_motion_field": P(DATA_AXIS),
            "compensated": P(DATA_AXIS, SPACE_AXIS, None),
            "diff_curr_prev": P(DATA_AXIS, SPACE_AXIS, None),
            "diff_curr_comp": P(DATA_AXIS, SPACE_AXIS, None),
            "psnr": P(DATA_AXIS),
            "volume_edge_hits": P(DATA_AXIS),
        },
        check_vma=False,
    )
    def sharded(prev_b, curr_b):
        return jax.vmap(pair_step)(prev_b, curr_b)

    return jax.jit(sharded)
