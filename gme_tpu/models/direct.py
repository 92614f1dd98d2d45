"""Direct (gradient-descent) global-motion estimation.

The reference attempted *direct* parameter estimation — minimising the
photometric error between the motion-compensated previous frame and the
current frame — three separate times and abandoned every attempt as
non-functional (reference `test scripts/gradient descent tests/`:
hand-rolled NumPy GD `motion.py:108-147`, a PyTorch Adam attempt declared
"does not work" at `testing_GD_with_pytorch.py:33-38`, and a SymPy Hessian
attempt marked "#! does not work" at `hessian_gradient.py:82-85`).  The
root causes were structural: integer-rounded warps (no gradient), per-pixel
Python loops, no smooth interpolation — and wildly mismatched parameter
scales (the perspective terms a6/a7 move pixels by ~coordinate², the linear
terms by ~coordinate, the offsets by 1).

This module is the working JAX realisation of that feature:

- the legacy 8-parameter **perspective model** of the reference prototype
  (gd tests/motion.py:51-63: x' = (a0 + a2*x + a3*y) / (a6*x + a7*y + 1),
  y' = (a1 + a4*x + a5*y) / (a6*x + a7*y + 1)) and the 6-parameter affine
  displacement model (motion.py:91-105), vectorised over the pixel grid;
- a **differentiable backward warp** (bilinear gather, clamp-to-edge) so
  the photometric SSD loss (gd tests/motion.py:9-23) has usable gradients —
  JAX autodiff replaces the reference's symbolic/handmade derivatives;
- **normalised-coordinate optimisation**: internally every level optimises
  on coordinates divided by max(H, W), which puts all parameters on an O(1)
  scale (a6/a7 included) so Adam converges without per-model hand-tuning.
  Normalised parameters are scale-invariant, so the prototype's projection
  rule (a0,a1 doubled, a6,a7 halved per finer level — gd tests/
  motion.py:95-105) becomes the identity between pyramid levels; the rule
  is still exported as `project_params` for pixel-unit parameters;
- coarse-to-fine over the Gaussian pyramid with a fixed per-level iteration
  budget inside `lax.scan` (static shapes, one compile), Adam via optax;
- a vectorised **forward-warp** compensator matching the prototype's
  scatter semantics (gd tests/motion.py:66-80: destination coords clamped
  to the frame, the LAST source pixel in row-major order wins on
  collisions) made deterministic with a rank-keyed scatter-max, plus the
  standard backward compensator.

Directionality: estimated parameters map CURRENT-frame coordinates to
PREVIOUS-frame coordinates (a backward warp — `warp_backward(previous,
params)` reconstructs the current frame).  `warp_forward` implements the
prototype's forward scatter and therefore expects the inverse mapping
(previous→current); feeding estimated parameters to it compensates in the
wrong direction.

Everything is jit-compatible and batchable with `jax.vmap`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import optax
from jax import lax

from gme_tpu.ops.pyramid import get_pyramids

N_MAX_ITERATIONS = 100  # the prototype's budget, reference gd tests/motion.py:6
DEFAULT_ITERATIONS = 300  # per level (empirically: exact recovery at 3 levels)
# Peak Adam step in normalised-coordinate units; cosine-decayed to 0 within
# each level so the final oscillation is far below a pixel (0.01 * max(H,W)
# would otherwise bound the achievable precision).
DEFAULT_LEARNING_RATE = 0.01

# ---------------------------------------------------------------------------
# Motion models (vectorised over coordinate grids)
# ---------------------------------------------------------------------------


def perspective_model(params: jnp.ndarray, x, y) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mapped coordinates under the 8-param perspective model.

    params = [a0..a7]; mirrors gd tests/motion.py:51-63 but without the
    int() truncation (smooth, so it differentiates) and without the bare
    try/except on a vanishing denominator — the denominator is kept away
    from zero by a tiny signed epsilon instead.
    """
    p = params
    den = p[6] * x + p[7] * y + 1.0
    den = jnp.where(jnp.abs(den) < 1e-6, jnp.where(den < 0, -1e-6, 1e-6), den)
    x1 = (p[0] + p[2] * x + p[3] * y) / den
    y1 = (p[1] + p[4] * x + p[5] * y) / den
    return x1, y1


def affine_coords(params: jnp.ndarray, x, y) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mapped coordinates under the 6-param affine DISPLACEMENT model
    (reference motion.py:91-105): source = coord + displacement."""
    p = params
    x1 = x + p[0] + p[1] * x + p[2] * y
    y1 = y + p[3] + p[4] * x + p[5] * y
    return x1, y1


def identity_params(model: str) -> jnp.ndarray:
    """Parameters mapping every pixel to itself."""
    if model == "perspective":
        # x' = (a0 + a2 x + a3 y)/(...): identity needs a2 = a5 = 1 — the
        # same fact the prototype discovered the hard way (gd tests/
        # motion.py:46 "#! first initialization needs a2 and a5 to be 1").
        return jnp.array([0, 0, 1, 0, 0, 1, 0, 0], jnp.float32)
    if model == "affine":
        return jnp.zeros((6,), jnp.float32)
    raise ValueError(f"unknown model {model!r}")


def project_params(params: jnp.ndarray, model: str) -> jnp.ndarray:
    """One pyramid level finer, for PIXEL-unit parameters.  Perspective:
    a0,a1 *= 2, a6,a7 /= 2 (gd tests/motion.py:95-105).  Affine: a0,b0 *= 2
    (motion.py:191-207).  (The internal normalised-coordinate optimisation
    does not need this — normalised parameters are scale-invariant.)"""
    if model == "perspective":
        s = jnp.array([2, 2, 1, 1, 1, 1, 0.5, 0.5], jnp.float32)
    else:
        s = jnp.array([2, 1, 1, 2, 1, 1], jnp.float32)
    return params * s


def params_to_pixel(params: jnp.ndarray, scale: float, model: str) -> jnp.ndarray:
    """Convert normalised-coordinate parameters (coords / scale) to
    pixel-coordinate parameters.  Same scaling family as `project_params`
    (that rule is exactly this conversion with scale ratio 2)."""
    if model == "perspective":
        s = jnp.array(
            [scale, scale, 1, 1, 1, 1, 1.0 / scale, 1.0 / scale], jnp.float32
        )
    else:
        s = jnp.array([scale, 1, 1, scale, 1, 1], jnp.float32)
    return params * s


def params_from_pixel(params: jnp.ndarray, scale: float, model: str) -> jnp.ndarray:
    """Inverse of `params_to_pixel`."""
    return params_to_pixel(params, 1.0 / scale, model)


def _model_coords(model: str, params, x, y):
    if model == "perspective":
        return perspective_model(params, x, y)
    return affine_coords(params, x, y)


# ---------------------------------------------------------------------------
# Differentiable warps
# ---------------------------------------------------------------------------


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear lookup img[x, y] with clamp-to-edge (x = row coordinate,
    matching the reference's (i, j) = (row, col) convention throughout
    gd tests/motion.py:66-80).  The CONTINUOUS coordinates are clamped
    before the floor split, so out-of-bounds samples resolve to the true
    edge pixel (and its gradient) instead of blending interior rows."""
    H, W = img.shape
    img = img.astype(jnp.float32)
    x = jnp.clip(x, 0.0, H - 1.0)
    y = jnp.clip(y, 0.0, W - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, H - 1)
    x1i = jnp.clip(x0i + 1, 0, H - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, W - 1)
    y1i = jnp.clip(y0i + 1, 0, W - 1)
    v00 = img[x0i, y0i]
    v01 = img[x0i, y1i]
    v10 = img[x1i, y0i]
    v11 = img[x1i, y1i]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * (1 - fx) * fy
        + v10 * fx * (1 - fy)
        + v11 * fx * fy
    )


def warp_backward(
    frame: jnp.ndarray, params: jnp.ndarray, model: str = "perspective"
) -> jnp.ndarray:
    """Differentiable backward warp: out[i, j] = frame[model(i, j)]
    (bilinear).  Float32 output in [0, 255].  `params` are pixel-unit."""
    H, W = frame.shape
    xs = lax.broadcasted_iota(jnp.float32, (H, W), 0)
    ys = lax.broadcasted_iota(jnp.float32, (H, W), 1)
    x1, y1 = _model_coords(model, params, xs, ys)
    return bilinear_sample(frame, x1, y1)


def warp_forward(
    frame: jnp.ndarray, params: jnp.ndarray, model: str = "perspective"
) -> jnp.ndarray:
    """Forward (scatter) warp with the legacy prototype's semantics
    (gd tests/motion.py:66-80): each source pixel (i, j) is written to the
    truncated mapped coordinate, clamped into the frame; pixels nothing
    maps to stay 0; among colliding writes the LAST source pixel in
    row-major order wins (the prototype's loop order).  Collisions resolve
    deterministically via a rank-keyed scatter-max (XLA's duplicate-index
    `.set` application order is unspecified).

    NOTE: expects a previous→current (forward) mapping — the INVERSE of the
    parameters estimated by `direct_global_motion_estimation` (see module
    docstring on directionality).
    """
    H, W = frame.shape
    xs = lax.broadcasted_iota(jnp.float32, (H, W), 0)
    ys = lax.broadcasted_iota(jnp.float32, (H, W), 1)
    x1, y1 = _model_coords(model, params, xs, ys)
    xd = jnp.clip(x1.astype(jnp.int32), 0, H - 1)
    yd = jnp.clip(y1.astype(jnp.int32), 0, W - 1)
    # Pack (row-major source rank, pixel value) into one int32 key so that
    # scatter-max selects the highest-rank (= last-written) source pixel.
    # Scatter-max the row-major source rank alone (exact for any frame under
    # 2**31 pixels — a packed rank*256+value key would overflow int32 past
    # ~8.4MP), then gather each destination's winning source value.
    rank = lax.broadcasted_iota(jnp.int32, (H, W), 0) * W + lax.broadcasted_iota(
        jnp.int32, (H, W), 1
    )
    win = jnp.full((H, W), -1, jnp.int32)
    win = win.at[xd.reshape(-1), yd.reshape(-1)].max(rank.reshape(-1))
    val = jnp.clip(jnp.round(frame.astype(jnp.float32)), 0, 255).astype(jnp.int32)
    out = val.reshape(-1)[jnp.clip(win, 0, H * W - 1).reshape(-1)].reshape(H, W)
    return jnp.where(win < 0, 0, out).astype(frame.dtype)


# ---------------------------------------------------------------------------
# Direct estimation (the working gradient descent)
# ---------------------------------------------------------------------------


def photometric_loss(
    params: jnp.ndarray,
    previous: jnp.ndarray,
    current: jnp.ndarray,
    model: str,
    coord_scale: float = 1.0,
) -> jnp.ndarray:
    """Mean squared photometric error between the backward-warped previous
    frame and the current frame (the SSD of gd tests/motion.py:9-23,
    normalised so the loss scale is resolution-independent).  `params` are
    in normalised coordinates when `coord_scale` > 1 (coords / scale)."""
    H, W = previous.shape
    xs = lax.broadcasted_iota(jnp.float32, (H, W), 0) * (1.0 / coord_scale)
    ys = lax.broadcasted_iota(jnp.float32, (H, W), 1) * (1.0 / coord_scale)
    x1, y1 = _model_coords(model, params, xs, ys)
    warped = bilinear_sample(previous, x1 * coord_scale, y1 * coord_scale)
    err = warped - current.astype(jnp.float32)
    return jnp.mean(err * err)


@functools.partial(
    jax.jit, static_argnames=("model", "iterations", "learning_rate")
)
def optimize_level(
    params: jnp.ndarray,
    previous: jnp.ndarray,
    current: jnp.ndarray,
    model: str = "perspective",
    iterations: int = DEFAULT_ITERATIONS,
    learning_rate: float = DEFAULT_LEARNING_RATE,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-budget Adam minimisation of the photometric loss at one level.

    `params` are NORMALISED-coordinate parameters (coords / max(H, W)): the
    linear terms move pixels by ~1·coordinate, the perspective terms by
    ~coordinate² — on [0, 1]-ish coordinates every parameter has O(1)
    scale, which is what makes this converge where the reference's
    prototypes (and a naive pixel-coordinate Adam) diverge.  The learning
    rate cosine-decays to 0 within the level: Adam's step magnitude ~ lr,
    so a constant lr would leave an O(lr·max(H,W))-pixel limit cycle.

    A bounded `lax.scan` (one compile, static shapes) replaces the
    reference's N_MAX_ITERATIONS Python loop that never computed a usable
    gradient.  Returns (final params, per-iteration loss trace).
    """
    prev_f = previous.astype(jnp.float32)
    curr_f = current.astype(jnp.float32)
    scale = float(max(previous.shape))
    opt = optax.adam(optax.cosine_decay_schedule(learning_rate, iterations))
    grad_fn = jax.value_and_grad(photometric_loss)

    def step(carry, _):
        p, opt_state = carry
        loss, g = grad_fn(p, prev_f, curr_f, model, scale)
        updates, opt_state = opt.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        return (p, opt_state), loss

    (params, _), losses = lax.scan(
        step, (params, opt.init(params)), None, length=iterations
    )
    return params, losses


def direct_global_motion_estimation(
    previous: jnp.ndarray,
    current: jnp.ndarray,
    model: str = "perspective",
    levels: int = 3,
    iterations: int = DEFAULT_ITERATIONS,
    learning_rate: float = DEFAULT_LEARNING_RATE,
) -> jnp.ndarray:
    """Coarse-to-fine direct GME: the working version of the reference's
    abandoned `global_motion_estimation` prototype (gd tests/motion.py:150+).

    Pipeline: Gaussian pyramids (coarsest first, reference utils.py:34-51)
    → identity init at the coarsest level → per level: Adam refinement of
    the photometric loss in normalised coordinates (scale-invariant, so no
    parameter projection is needed between levels — the prototype's
    ×2/÷2 rule is the identity here).

    Returns the (8,) perspective or (6,) affine parameters in PIXEL units
    at full resolution, mapping current-frame to previous-frame coordinates
    (see module docstring on directionality).
    """
    prev_pyr = get_pyramids(previous, levels)
    curr_pyr = get_pyramids(current, levels)
    params = identity_params(model)  # identity in any coordinate scale
    for lvl in range(levels):
        params, _ = optimize_level(
            params,
            prev_pyr[lvl],
            curr_pyr[lvl],
            model=model,
            iterations=iterations,
            learning_rate=learning_rate,
        )
    return params_to_pixel(params, float(max(previous.shape)), model)


def direct_motion_compensation(
    previous: jnp.ndarray,
    current: jnp.ndarray,
    model: str = "perspective",
    **kw,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One-shot direct estimate + backward compensation.

    Returns (params, compensated uint8 frame) — the shape of the one-shot
    `motion_compensation` wrapper (reference motion.py:324-341) for the
    direct path.
    """
    params = direct_global_motion_estimation(previous, current, model, **kw)
    comp = warp_backward(previous, params, model)
    return params, jnp.clip(jnp.round(comp), 0, 255).astype(jnp.uint8)
