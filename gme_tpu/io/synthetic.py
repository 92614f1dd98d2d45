"""Seeded synthetic clips with known global motion.

The reference's test videos are not part of this repository, so on-card
checks generate their input: a multi-octave value-noise texture (smooth
regions, edges and fine detail, unlike i.i.d. noise, so block searches walk
several steps and meet ties) seen through a window that pans by a fixed
(rows, cols) step per frame, plus a little sensor noise.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _value_noise(rng: np.random.RandomState, H: int, W: int, cell: int) -> np.ndarray:
    """(H, W) bilinear interpolation of a random grid with `cell`-px spacing."""
    grid = rng.rand(H // cell + 2, W // cell + 2)
    y = np.arange(H) / cell
    x = np.arange(W) / cell
    y0, x0 = y.astype(int), x.astype(int)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def textured_pan(
    n_frames: int,
    height: int,
    width: int,
    pan: Tuple[int, int] = (1, 2),
    seed: int = 0,
    noise: int = 2,
) -> List[np.ndarray]:
    """`n_frames` (height, width) uint8 frames; frame i is the texture
    window at (i * pan[0], i * pan[1]), so the content of frame i+1 at p
    is that of frame i at p + pan (up to +-`noise` grey levels)."""
    rng = np.random.RandomState(seed)
    dy, dx = pan
    Ht = height + abs(dy) * (n_frames - 1)
    Wt = width + abs(dx) * (n_frames - 1)
    tex = sum(
        amp * _value_noise(rng, Ht, Wt, cell)
        for cell, amp in ((96, 1.0), (24, 0.6), (6, 0.35), (2, 0.15))
    )
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 235.0 + 10.0
    r0 = 0 if dy >= 0 else Ht - height
    c0 = 0 if dx >= 0 else Wt - width
    frames = []
    for i in range(n_frames):
        r, c = r0 + i * dy, c0 + i * dx
        f = tex[r : r + height, c : c + width]
        f = f + rng.randint(-noise, noise + 1, f.shape)
        frames.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return frames
