"""gme_tpu — a global-motion-estimation framework for accelerators.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``Samaretas/global-motion-estimation`` project (block-based motion estimation,
hierarchical affine global-motion fitting, motion compensation, PSNR scoring):
batched static-shape tensor programs that run on an NVIDIA GPU (or the CPU),
and `jax.sharding` meshes for data/spatial parallelism.

Public API (mirrors the reference's behavioural surface; citations to the
reference sources are in each symbol's docstring):

- :func:`gme_tpu.ops.bbme.get_motion_field`    — reference bbme.py:12-38
- :func:`gme_tpu.models.gme.global_motion_estimation` — reference motion.py:109-136
- :func:`gme_tpu.models.gme.motion_compensation`      — reference motion.py:324-341
- :func:`gme_tpu.ops.affine.get_motion_field_affine`  — reference motion.py:139-157
- :func:`gme_tpu.ops.warp.compensate_frame`           — reference motion.py:289-321
- :func:`gme_tpu.ops.metrics.psnr`                    — reference utils.py:100-116
- :func:`gme_tpu.ops.pyramid.get_pyramids`            — reference utils.py:34-51
"""

from gme_tpu.config import BBMEConfig, GMEConfig, PipelineConfig
from gme_tpu.ops.pyramid import get_pyramids, pyrdown
from gme_tpu.ops.bbme import get_motion_field
from gme_tpu.ops.affine import get_motion_field_affine, affine_model
from gme_tpu.ops.warp import compensate_frame
from gme_tpu.ops.metrics import psnr
from gme_tpu.models.gme import (
    global_motion_estimation,
    motion_compensation,
    gme_pipeline_step,
)

__version__ = "0.1.0"

__all__ = [
    "BBMEConfig",
    "GMEConfig",
    "PipelineConfig",
    "get_pyramids",
    "pyrdown",
    "get_motion_field",
    "get_motion_field_affine",
    "affine_model",
    "compensate_frame",
    "psnr",
    "global_motion_estimation",
    "motion_compensation",
    "gme_pipeline_step",
]
