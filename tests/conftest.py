"""Test configuration: CPU with 8 virtual devices unless told otherwise.

Multi-device sharding paths (data-parallel batches, spatial shards + halo
exchange, psum'd fits) run without accelerators via XLA's host-platform
device-count override — the standard JAX stand-in for a real mesh.
`JAX_PLATFORMS` defaults to cpu; tests marked `gpu` need the card and skip
without one (see the `gpu` fixture).  Must run before the first
`import jax`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(scope="session")
def goldens():
    def load(name):
        path = os.path.join(GOLDENS, name)
        if not os.path.exists(path):
            pytest.skip(f"golden fixture {name} not generated")
        return np.load(path)

    return load


@pytest.fixture(scope="session")
def gpu():
    """The first NVIDIA GPU; skips where there is none.  Decided here, at
    run time, so every pytest-xdist worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run on the card: python chip_smoke.py)")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(7)


def synth_pair(rng, H, W, shift=(2, -3), noise=8):
    """Synthetic translating frame pair with additive noise."""
    prev = rng.randint(0, 256, (H, W), np.uint8)
    curr = np.roll(prev, shift, (0, 1))
    curr = np.clip(curr.astype(int) + rng.randint(-noise, noise + 1, (H, W)), 0, 255)
    return prev, curr.astype(np.uint8)


def synth_affine_pair(H, W, params, seed=0):
    """Frame pair where `curr` moves by an exact affine field of `params`.

    Built so that ground truth is known: sample a smooth random image, then
    set curr[p] = prev[p - d(p)] with d from the affine model evaluated per
    block cell — the inverse of the compensation warp.
    """
    rng_ = np.random.RandomState(seed)
    base = rng_.randint(0, 256, (H // 8, W // 8)).astype(np.float32)
    big = np.kron(base, np.ones((8, 8), np.float32))  # smooth blocky image
    prev = big.astype(np.uint8)
    a0, a1, a2, b0, b1, b2 = params
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # cell coords at block granularity 16 as in the pipeline
    ci, cj = ii // 16, jj // 16
    dx = np.rint(a0 + a1 * ci + a2 * cj).astype(int)
    dy = np.rint(b0 + b1 * ci + b2 * cj).astype(int)
    src_r = np.clip(ii - dy, 0, H - 1)
    src_c = np.clip(jj - dx, 0, W - 1)
    curr = prev[src_r, src_c]
    return prev, curr
