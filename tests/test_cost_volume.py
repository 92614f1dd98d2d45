"""Volume-engine parity tests: the DFD cost volume, the exhaustive sweep,
the successor-map builders and the fixpoint chase, each against a NumPy
oracle written from the reference's per-block loops."""

import numpy as np
import pytest
import jax.numpy as jnp

from gme_tpu.config import MAE, MSE
from gme_tpu.ops import bbme


def _np_cost_volume(prev, cpad, bs, D, pnorm):
    Hc, Wc = prev.shape
    nbh, nbw = Hc // bs, Wc // bs
    out = np.zeros((D, D, nbh, nbw), np.float32)
    for i in range(D):
        for j in range(D):
            d = cpad[i : i + Hc, j : j + Wc] - prev
            p = np.abs(d) if pnorm == MAE else d * d
            out[i, j] = p.reshape(nbh, bs, nbw, bs).sum(axis=(1, 3))
    return out


@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize(
    "bs,Hc,Wc,D",
    [
        (8, 32, 40, 9),
        (4, 24, 24, 7),
        (2, 16, 24, 5),
        # Dense-init family (bs < 8): D odd and even, nbh not a multiple of 8.
        (2, 16, 24, 9),
        (4, 24, 32, 13),
        (2, 36, 64, 33),
        (4, 52, 68, 11),
        # GME-level family: block edges 8, 12 and 16, wide and narrow D.
        (16, 48, 80, 9),
        (16, 32, 48, 33),
        (8, 40, 56, 17),
        (12, 36, 60, 21),
    ],
)
def test_cost_volume_core_matches_numpy_oracle(rng, pnorm, bs, Hc, Wc, D):
    prev = rng.randint(0, 256, (Hc, Wc)).astype(np.float32)
    cpad = rng.randint(0, 256, (Hc + D - 1, Wc + D - 1)).astype(np.float32)
    got = np.asarray(
        bbme._cost_volume_core(jnp.asarray(prev), jnp.asarray(cpad), bs, D, pnorm)
    )
    want = _np_cost_volume(prev, cpad, bs, D, pnorm)
    np.testing.assert_array_equal(got, want)


def _np_masked_volume(prev, curr, bs, R, pnorm):
    """(nbh, nbw, D*D) oracle: per block and offset, the DFD of the candidate
    block, +inf when it leaves the frame (reference bbme.py:157-162)."""
    H, W = prev.shape
    nbh, nbw = H // bs, W // bs
    D = 2 * R + 1
    p32, c32 = prev.astype(np.float32), curr.astype(np.float32)
    out = np.full((nbh, nbw, D * D), np.inf, np.float32)
    for bi in range(nbh):
        for bj in range(nbw):
            r0, c0 = bi * bs, bj * bs
            anchor = p32[r0 : r0 + bs, c0 : c0 + bs]
            for dr in range(-R, R + 1):
                for dc in range(-R, R + 1):
                    r, c = r0 + dr, c0 + dc
                    if r < 0 or c < 0 or r + bs > H or c + bs > W:
                        continue
                    d = c32[r : r + bs, c : c + bs] - anchor
                    v = np.abs(d).sum() if pnorm == MAE else (d * d).sum()
                    out[bi, bj, (dr + R) * D + (dc + R)] = v
    return out


@pytest.mark.parametrize("pnorm", [MAE, MSE])
def test_compute_cost_volume_matches_masked_oracle(rng, pnorm):
    """Masked volume through compute_cost_volume == the per-block oracle,
    bit for bit, including the +inf out-of-frame mask."""
    H, W, bs, R = 48, 56, 8, 8
    prev = rng.randint(0, 256, (H, W), np.uint8)
    curr = rng.randint(0, 256, (H, W), np.uint8)
    got = np.asarray(
        bbme.compute_cost_volume(jnp.asarray(prev), jnp.asarray(curr), bs, R, pnorm)
    )
    want = _np_masked_volume(prev, curr, bs, R, pnorm)
    assert (np.isfinite(got) == np.isfinite(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[fin], want[fin])


def _np_exhaustive(prev, curr, bs, sw, pnorm):
    """Reference bbme.py:105-179 loop for loop: window_col outer,
    window_row inner over range(-sw, sw + bs), strict-< first minimum,
    out-of-frame candidates skipped."""
    H, W = prev.shape
    p32, c32 = prev.astype(np.float32), curr.astype(np.float32)
    field = np.zeros((H // bs, W // bs, 2), np.int32)
    for bi in range(H // bs):
        for bj in range(W // bs):
            r0, c0 = bi * bs, bj * bs
            anchor = p32[r0 : r0 + bs, c0 : c0 + bs]
            best, best_d = np.inf, (0, 0)
            for wc in range(-sw, sw + bs):
                for wr in range(-sw, sw + bs):
                    r, c = r0 + wr, c0 + wc
                    if r < 0 or c < 0 or r + bs - 1 > H - 1 or c + bs - 1 > W - 1:
                        continue
                    d = c32[r : r + bs, c : c + bs] - anchor
                    v = np.abs(d).sum() if pnorm == MAE else (d * d).sum()
                    if v < best:
                        best, best_d = v, (wc, wr)
            field[bi, bj] = best_d
    return field


def test_exhaustive_matches_bruteforce_oracle(rng):
    """exhaustive_search's lax.map sweep == the brute-force per-block scan,
    including the reference's asymmetric window and tie-breaking order."""
    H, W, bs, sw = 36, 48, 12, 8
    prev = rng.randint(0, 256, (H, W), np.uint8)
    curr = rng.randint(0, 256, (H, W), np.uint8)
    got = np.asarray(
        bbme.exhaustive_search(jnp.asarray(prev), jnp.asarray(curr), MAE, bs, sw)
    )
    np.testing.assert_array_equal(got, _np_exhaustive(prev, curr, bs, sw, MAE))


# ---------------------------------------------------------------------------
# Successor-map builder parity (diamond walk)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,bs,R", [(48, 64, 16, 6), (20, 28, 2, 5), (40, 40, 8, 12)])
def test_succ_map_packed_matches_select(rng, H, W, bs, R):
    """The packed-minimum successor-map builder (production) == the
    select-chain builder (verification twin), bit for bit, on a real masked
    cost volume — including frame-border blocks where the reference's
    position clamps (bbme.py:503-504) saturate candidates."""
    prev = jnp.asarray(rng.randint(0, 256, (H, W), np.uint8))
    curr = jnp.asarray(rng.randint(0, 256, (H, W), np.uint8))
    vol = bbme.compute_cost_volume(prev, curr, bs, R, MSE)
    nbh, nbw = H // bs, W // bs
    origins = bbme._block_origins(nbh, nbw, bs)

    want = np.asarray(bbme._succ_map_select(vol, origins, H, W, bs, R))
    got = np.asarray(bbme._succ_map_packed(vol, origins, H, W, bs, R))
    np.testing.assert_array_equal(got, want)


def test_succ_map_packed_ties_and_inf(rng):
    """Tie-breaking (strict <, LDSP order) and all-inf blocks behave exactly
    like the select builder on adversarial volumes: constant volumes (every
    candidate ties), fully-masked (+inf) volumes, and the maximum
    representable cost (255^2 * bs^2, the pack-exactness boundary)."""
    H, W, bs, R = 32, 32, 8, 4
    nbh, nbw = H // bs, W // bs
    D = 2 * R + 1
    origins = bbme._block_origins(nbh, nbw, bs)

    max_cost = float(255 * 255 * bs * bs)
    for vol in (
        jnp.zeros((nbh, nbw, D * D), jnp.float32),
        jnp.full((nbh, nbw, D * D), np.inf, jnp.float32),
        jnp.full((nbh, nbw, D * D), max_cost, jnp.float32),
        jnp.asarray(
            np.random.RandomState(3).choice(
                [0.0, 1.0, max_cost, np.inf], (nbh, nbw, D * D)
            ).astype(np.float32)
        ),
    ):
        want = np.asarray(bbme._succ_map_select(vol, origins, H, W, bs, R))
        got = np.asarray(bbme._succ_map_packed(vol, origins, H, W, bs, R))
        np.testing.assert_array_equal(got, want)


def test_chase_matches_sequential_oracle(rng):
    """The XLA fixpoint chase in `diamond_walk_volume` == a per-cell
    sequential NumPy walk over the same rank map, followed by the SDSP pass:
    same final positions and the same ring-visited flags — on plain motion
    AND on a shift big enough to escape the radius (walks clamped at the
    volume edge)."""
    H, W, bs, R = 48, 64, 8, 5
    D = 2 * R + 1
    nbh, nbw = H // bs, W // bs
    origins = bbme._block_origins(nbh, nbw, bs)
    og = np.asarray(origins).reshape(-1, 2)
    lo_r, hi_r = -og[:, 0], (H - bs - 1) - og[:, 0]
    lo_c, hi_c = -og[:, 1], (W - bs - 1) - og[:, 1]
    for shift in (2, 9):  # 9 > R: forces ring visits and volume clamping
        base = rng.randint(0, 256, (H + shift, W + shift), np.uint8)
        prev = jnp.asarray(base[:H, :W])
        curr = jnp.asarray(base[shift:, shift:])
        vol = bbme.compute_cost_volume(prev, curr, bs, R, MSE)
        vol_np = np.asarray(vol).reshape(-1, D * D)
        rank = np.asarray(bbme._succ_map(vol, origins, H, W, bs, R)).reshape(
            -1, D * D
        )

        exp_best = np.zeros((len(og), 2), np.int32)
        exp_t = np.zeros(len(og), bool)
        for cell in range(len(og)):
            o = R * D + R
            for _ in range(4096):
                r, c = o // D - R, o % D - R
                exp_t[cell] |= max(abs(r), abs(c)) >= R - 1
                a, b = bbme._LDSP[rank[cell, o]]
                er = np.clip(r + a, lo_r[cell], hi_r[cell])
                ec = np.clip(c + b, lo_c[cell], hi_c[cell])
                nxt = (er + R) * D + (ec + R)
                if nxt == o:
                    break
                o = nxt
            # SDSP pass (reference bbme.py:515-529): first strict minimum.
            match = og[cell] + (o // D - R, o % D - R)
            best_cost = np.inf
            for a, b in bbme._SDSP:
                pos = (
                    np.clip(match[0] + a, 0, H - bs - 1),
                    np.clip(match[1] + b, 0, W - bs - 1),
                )
                off = (pos[0] - og[cell, 0], pos[1] - og[cell, 1])
                cost = (
                    vol_np[cell, (off[0] + R) * D + (off[1] + R)]
                    if max(abs(off[0]), abs(off[1])) <= R
                    else np.inf
                )
                if cost < best_cost or (a, b) == (0, 0):
                    best_cost, exp_best[cell] = cost, pos

        got_best, hits = bbme.diamond_walk_volume(
            vol, origins, H, W, bs, R, with_diagnostics=True
        )
        np.testing.assert_array_equal(
            np.asarray(got_best).reshape(-1, 2), exp_best, err_msg=f"shift={shift}"
        )
        assert int(hits) == int(exp_t.sum()), f"shift={shift}"
        # Per-cell flags through the count mask: every other cell.
        mask = (np.arange(len(og)) % 2 == 0).reshape(nbh, nbw)
        _, hits_even = bbme.diamond_walk_volume(
            vol, origins, H, W, bs, R, with_diagnostics=True,
            count_mask=jnp.asarray(mask),
        )
        assert int(hits_even) == int(exp_t[mask.reshape(-1)].sum())
