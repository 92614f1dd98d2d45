"""Hierarchical affine global-motion estimation — the flagship model.

Re-design of reference motion.py:109-136 (coarse-to-fine robust
fit) and the results-pipeline per-pair step (reference results.py:41-112) as
one jit-compilable, vmap-able function of two frames.

Level schedule (reference motion.py:122-134): 3-level Gaussian pyramid,
coarsest first; translation-only init from a dense block-2 diamond search at
the coarsest level (motion.py:27-30, 160-188); then per finer level:
parameter projection (a0,b0 *= 2) and a robust re-fit with 30% outlier
rejection.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gme_tpu.config import GMEConfig
from gme_tpu.ops.affine import (
    compute_first_parameters,
    fit_normal_equations,
    get_motion_field_affine,
    outlier_mask,
    parameter_projection,
)
from gme_tpu.ops.bbme import get_motion_field
from gme_tpu.ops.metrics import frame_difference, psnr
from gme_tpu.ops.pyramid import get_pyramids
from gme_tpu.ops.warp import compensate_frame

_DEFAULT = GMEConfig()


def dense_motion_estimation(
    previous, current, cfg: GMEConfig = _DEFAULT, return_diagnostics=False
):
    """Dense init field: block-2 diamond search (reference motion.py:13-30)."""
    return get_motion_field(
        previous,
        current,
        block_size=cfg.dense_block_size,
        search_window=cfg.search_window,
        searching_procedure=cfg.searching_procedure,
        max_iters=cfg.max_search_iters,
        search_impl=cfg.search_impl,
        volume_radius=cfg.dense_volume_radius,
        return_diagnostics=return_diagnostics,
    )


def first_parameter_estimation(previous, current, cfg: GMEConfig = _DEFAULT):
    """Translation-only first estimate (reference motion.py:160-173)."""
    return compute_first_parameters(dense_motion_estimation(previous, current, cfg))


def best_affine_parameters(previous, current, cfg: GMEConfig = _DEFAULT):
    """Non-robust closed-form fit (reference motion.py:33-88)."""
    gt = get_motion_field(
        previous,
        current,
        block_size=cfg.block_size,
        search_window=cfg.search_window,
        searching_procedure=cfg.searching_procedure,
        max_iters=cfg.max_search_iters,
        search_impl=cfg.search_impl,
        volume_radius=cfg.volume_radius,
    )
    inliers = jnp.ones(gt.shape[:2], dtype=bool)
    return fit_normal_equations(gt, inliers, previous.shape, cfg.coord_stride)


def best_affine_parameters_robust(
    previous, current, old_parameters, cfg: GMEConfig = _DEFAULT,
    return_diagnostics=False,
):
    """Robust fit: BBME field -> outlier mask vs old-params affine field ->
    masked normal equations (reference motion.py:210-286)."""
    gt = get_motion_field(
        previous,
        current,
        block_size=cfg.block_size,
        search_window=cfg.search_window,
        searching_procedure=cfg.searching_procedure,
        max_iters=cfg.max_search_iters,
        search_impl=cfg.search_impl,
        volume_radius=cfg.volume_radius,
        return_diagnostics=return_diagnostics,
    )
    diag = None
    if return_diagnostics:
        gt, diag = gt
    affine_field = get_motion_field_affine(gt.shape[:2], old_parameters)
    inliers = outlier_mask(gt, affine_field, cfg.outlier_fraction)
    params = fit_normal_equations(gt, inliers, previous.shape, cfg.coord_stride)
    if return_diagnostics:
        return params, diag
    return params


def global_motion_estimation(previous, current, cfg: GMEConfig = _DEFAULT):
    """Coarse-to-fine robust affine GME (reference motion.py:109-136).

    Args:
        previous, current: (H, W) uint8 grayscale frames.

    Returns:
        (6,) float32 parameters [a0,a1,a2,b0,b1,b2].
    """
    return global_motion_estimation_with_diagnostics(previous, current, cfg)[0]


def global_motion_estimation_with_diagnostics(
    previous, current, cfg: GMEConfig = _DEFAULT
):
    """`global_motion_estimation` plus runtime parity diagnostics: the total
    `volume_edge_hits` across the dense init and every pyramid level (walks
    that entered the volume's boundary-adjacent ring, where a larger radius
    could change the trajectory — see bbme.diamond_walk_volume)."""
    prev_pyr = get_pyramids(previous, cfg.pyramid_levels)
    curr_pyr = get_pyramids(current, cfg.pyramid_levels)

    field, diag = dense_motion_estimation(
        prev_pyr[0], curr_pyr[0], cfg, return_diagnostics=True
    )
    edge_hits = diag["volume_edge_hits"]
    parameters = compute_first_parameters(field)
    for i in range(1, cfg.pyramid_levels):
        parameters = parameter_projection(parameters)
        parameters, diag = best_affine_parameters_robust(
            prev_pyr[i], curr_pyr[i], parameters, cfg, return_diagnostics=True
        )
        edge_hits = edge_hits + diag["volume_edge_hits"]
    return parameters, {"volume_edge_hits": edge_hits}


def motion_compensation(previous, current, cfg: GMEConfig = _DEFAULT):
    """One-shot GME + warp of the previous frame (reference motion.py:324-341)."""
    parameters = global_motion_estimation(previous, current, cfg)
    shape = (previous.shape[0] // cfg.block_size, previous.shape[1] // cfg.block_size)
    motion_field = get_motion_field_affine(shape, parameters)
    return compensate_frame(previous, motion_field)


def gme_pipeline_step(
    previous, current, cfg: GMEConfig = _DEFAULT
) -> Dict[str, jnp.ndarray]:
    """One full results-pipeline step (reference results.py:47-110):
    GME -> dense affine field -> compensation -> diffs -> PSNR.

    jit/vmap-friendly: all outputs are arrays of static shape.
    """
    parameters, diag = global_motion_estimation_with_diagnostics(
        previous, current, cfg
    )
    shape = (previous.shape[0] // cfg.block_size, previous.shape[1] // cfg.block_size)
    model_motion_field = get_motion_field_affine(shape, parameters)
    compensated = compensate_frame(previous, model_motion_field)
    return {
        "parameters": parameters,
        "model_motion_field": model_motion_field,
        "compensated": compensated,
        "diff_curr_prev": frame_difference(current, previous),
        "diff_curr_comp": frame_difference(current, compensated),
        "psnr": psnr(current, compensated),
        "volume_edge_hits": diag["volume_edge_hits"],
    }


@partial(jax.jit, static_argnames=("cfg",))
def gme_pipeline_step_jit(previous, current, cfg: GMEConfig = _DEFAULT):
    return gme_pipeline_step(previous, current, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def gme_pipeline_batch(previous_batch, current_batch, cfg: GMEConfig = _DEFAULT):
    """vmap of the full step over a batch of frame pairs — the unit that
    shards over the `data` mesh axis (each pair is independent)."""
    return jax.vmap(lambda p, c: gme_pipeline_step(p, c, cfg))(
        previous_batch, current_batch
    )


@partial(jax.jit, static_argnames=("cfg",))
def global_motion_estimation_jit(previous, current, cfg: GMEConfig = _DEFAULT):
    return global_motion_estimation(previous, current, cfg)


@partial(jax.jit, static_argnames=())
def _merge_adaptive(fast_out, full_out, escaped):
    """Per-pair select: full-radius outputs where the fast tier's walk
    entered the volume boundary ring, fast outputs elsewhere."""

    def pick(a_full, a_fast):
        sel = escaped.reshape(escaped.shape[:1] + (1,) * (a_fast.ndim - 1))
        return jnp.where(sel, a_full, a_fast)

    return jax.tree_util.tree_map(pick, full_out, fast_out)


def gme_pipeline_batch_adaptive(
    previous_batch, current_batch, cfg: GMEConfig = _DEFAULT
) -> Dict[str, jnp.ndarray]:
    """Escape-guarded adaptive volume radius — the production dispatch.

    Two-tier host-level dispatch: the batch first runs with the tight radii
    (`cfg.fast()` — quadratically less cost-volume and successor-map work,
    the dominant stages at every resolution); pairs whose diamond walk ever
    entered the tight volume's boundary-adjacent ring (per-pair
    ``volume_edge_hits`` — the soundness certificate, see
    bbme.diamond_walk_volume) are recomputed at the full radii and merged
    per pair.  Bit-identical to `gme_pipeline_batch(cfg)` by construction:
    a zero-certificate pair's walk never consulted a successor the full
    volume could change.  The reference's walks are unbounded within frame
    clamps (reference bbme.py:494-513); the merged ``volume_edge_hits``
    carries the full-radius run's residual diagnostic for escaped pairs.
    """
    fast_out = gme_pipeline_batch(previous_batch, current_batch, cfg.fast())
    hits = np.asarray(fast_out["volume_edge_hits"])  # syncs the fast tier
    if not hits.any():
        return fast_out
    full_out = gme_pipeline_batch(previous_batch, current_batch, cfg)
    escaped = jnp.asarray(hits > 0)
    return _merge_adaptive(fast_out, full_out, escaped)
