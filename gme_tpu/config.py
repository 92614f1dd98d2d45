"""Configuration system for gme_tpu.

The reference has no config system beyond argparse + hand-edited module
constants (reference motion.py:9-10, bbme.py:685-711, results.py:117-136;
acknowledged deficiency in reference README.md:137-143).  Here every knob is a
frozen dataclass so configs are hashable and can be passed as `static_argnums`
to `jax.jit`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Searching-procedure indices — behavioural API preserved from the reference
# dispatch table (reference bbme.py:609-614).
EXHAUSTIVE = 0
THREESTEP = 1
TWODLOG = 2
DIAMOND = 3

# p-norm indices (reference bbme.py:608).
MAE = 0
MSE = 1

SEARCH_NAMES = {
    EXHAUSTIVE: "exhaustive",
    THREESTEP: "threestep",
    TWODLOG: "twodlog",
    DIAMOND: "diamond",
}

PNORM_NAMES = {MAE: "mae", MSE: "mse"}


@dataclass(frozen=True)
class BBMEConfig:
    """Block-based motion estimation parameters.

    Defaults preserve `get_motion_field`'s signature defaults
    (reference bbme.py:12-19: block_size=4, search_window=2,
    searching_procedure=1 (three-step), pnorm_distance=1 (MSE)).
    """

    block_size: int = 4
    search_window: int = 2
    searching_procedure: int = THREESTEP
    pnorm_distance: int = MSE
    # Upper bound on data-dependent search iterations (diamond / 2D-log large
    # patterns).  The reference uses unbounded `while` loops
    # (bbme.py:494, bbme.py:381); here they are lockstep `lax.while_loop`s
    # with this static safety bound.  Positions move by <=2 px/iteration and
    # are clamped to the frame, so max(H, W) iterations always suffices; the
    # bound exists to guarantee termination of compiled code.
    max_search_iters: int = 4096
    # Candidate-evaluation engine: "gather" (exact block gathers), "volume"
    # (precomputed shift+box-sum cost volume; spatial sharding always uses
    # it), or "auto" (gather on every backend).
    search_impl: str = "auto"
    # Half-width of the precomputed cost volume for impl="volume" walks.
    volume_radius: int = 32

    def replace(self, **kw) -> "BBMEConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GMEConfig:
    """Global-motion-estimation (affine model) parameters.

    Defaults preserve the reference constants: BBME_BLOCK_SIZE=16 and
    MOTION_VECTOR_ERROR_THRESHOLD_PERCENTAGE=0.3 (reference motion.py:9-10),
    pyramid levels=3 (reference utils.py:34), dense-init block_size=2 with
    diamond search (reference motion.py:27-30), and the hard-coded cell-
    coordinate stride of 4 in the normal-equation accumulation (reference
    motion.py:57-58, 254-255 — a quirk: stride 4 despite block size 16; kept
    behind `coord_stride` for output parity).
    """

    block_size: int = 16
    # Search window passed to the per-level motion search.  Default 2 is
    # `get_motion_field`'s signature default (reference bbme.py:12-19) —
    # the reference GME path never overrides it (motion.py:224).  Only
    # exhaustive/three-step consume it; diamond ignores it as the
    # reference does (bbme.py:436-534).
    search_window: int = 2
    pyramid_levels: int = 3
    outlier_fraction: float = 0.3
    coord_stride: int = 4
    dense_block_size: int = 2
    searching_procedure: int = DIAMOND
    pnorm_distance: int = MSE
    max_search_iters: int = 4096
    search_impl: str = "auto"
    volume_radius: int = 32
    # Radius for the dense (block-2) init search at the coarsest pyramid
    # level — motion there is 4x smaller, so a tighter volume suffices.
    dense_volume_radius: int = 16
    # Escape-guarded adaptive radii (models.gme.gme_pipeline_batch_adaptive):
    # the batch first runs with these tighter radii — quadratically less
    # volume + successor-map work — and any pair whose diamond walk entered
    # the volume's boundary-adjacent ring (volume_edge_hits > 0, the
    # soundness certificate of bbme.diamond_walk_volume) is recomputed at
    # the full radii above.  Results are bit-identical to a full-radius run
    # by construction.
    fast_volume_radius: int = 12
    fast_dense_volume_radius: int = 8

    def fast(self) -> "GMEConfig":
        """The tight-radius first-tier config of the adaptive dispatch."""
        return self.replace(
            volume_radius=self.fast_volume_radius,
            dense_volume_radius=self.fast_dense_volume_radius,
        )

    def bbme(self, block_size: Optional[int] = None) -> BBMEConfig:
        return BBMEConfig(
            block_size=self.block_size if block_size is None else block_size,
            search_window=self.search_window,
            searching_procedure=self.searching_procedure,
            pnorm_distance=self.pnorm_distance,
            max_search_iters=self.max_search_iters,
            search_impl=self.search_impl,
            volume_radius=self.volume_radius,
        )

    def replace(self, **kw) -> "GMEConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the parallel pipeline.

    The reference is single-threaded (SURVEY.md §2.2); parallelism here is
    a (data, space) mesh where independent frame pairs shard over
    the `data` axis and frame rows shard over the `space` axis (with
    search-window halo exchange for BBME).
    """

    data_axis: str = "data"
    space_axis: str = "space"
    data: int = 1
    space: int = 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.space)


@dataclass(frozen=True)
class PipelineConfig:
    """Full results-pipeline configuration (reference results.py:11,114-138)."""

    frame_distance: int = 1
    gme: GMEConfig = dataclasses.field(default_factory=GMEConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Batch of frame pairs processed per device dispatch.
    batch_size: int = 8
    # Resume from already-written outputs instead of wiping the results dir
    # (the reference rmtree's prior results at startup, results.py:23-24,
    # destroying resumability; we keep outputs idempotent and skippable).
    resume: bool = False
    write_images: bool = True
    # Escape-guarded adaptive volume radius (models.gme
    # .gme_pipeline_batch_adaptive): bit-identical to the full-radius run
    # by construction, and a large win when motion stays inside the tight
    # radii.  Opt-in: on fast global motion (e.g. pan240 — measured: every
    # pair trips the certificate) the full-radius fallback makes it pure
    # overhead.  Single-device (mesh 1x1) path only.
    adaptive: bool = False

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
