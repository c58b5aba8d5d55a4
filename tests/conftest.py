"""Test configuration: an 8-device virtual CPU platform, so all
sharding/mesh code paths run without an accelerator.

Tests marked ``gpu`` need the card; they skip unless JAX can see a GPU,
which the ``gpu_device`` fixture decides at run time. On a machine with
a card run them with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import jax
import numpy as np
import pytest

from amof_tpu.core.frames import Frame

# test runs compile hundreds of tiny programs: keep them out of the
# persistent cache, which lives inside the checkout
jax.config.update("jax_enable_compilation_cache", False)

REFERENCE_ZIF4 = pathlib.Path("/root/reference/examples/files/ZIF-4.xyz")
REFERENCE_CELL = pathlib.Path("/root/reference/examples/files/toy_trajectory.cell")


@pytest.fixture(scope="session")
def zif4_frame():
    """The 272-atom ZIF-4 unit cell used by the reference examples."""
    if not REFERENCE_ZIF4.exists():
        pytest.skip("ZIF-4 fixture not available")
    from amof_tpu.io.xyz import read_xyz

    frame = read_xyz(str(REFERENCE_ZIF4), 0)
    return frame


@pytest.fixture(scope="session")
def cp2k_cell_file():
    if not REFERENCE_CELL.exists():
        pytest.skip("toy_trajectory.cell fixture not available")
    return str(REFERENCE_CELL)


@pytest.fixture
def simple_cubic_frame():
    """4x4x4 simple cubic lattice of Ar, spacing 2.0 Å -> known neighbor
    counts (6 first neighbors at 2.0, 12 second at 2.83...)."""
    a = 2.0
    pts = np.array(
        [[i, j, k] for i in range(4) for j in range(4) for k in range(4)],
        dtype=np.float64,
    ) * a
    cell = np.eye(3) * 4 * a
    return Frame(pts, np.full(len(pts), 18), cell, pbc=True)


def _nacl(a=4.0, reps=1):
    base = np.array(
        [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]
    )
    cl_off = np.array([0.5, 0, 0])
    frac = np.concatenate([base, (base + cl_off) % 1.0])
    numbers = np.array([11] * 4 + [17] * 4)
    # replicate
    cells = np.array(
        [[i, j, k] for i in range(reps) for j in range(reps) for k in range(reps)]
    )
    frac_all = ((frac[None, :, :] + cells[:, None, :]) / reps).reshape(-1, 3)
    numbers_all = np.tile(numbers, reps**3)
    return Frame(frac_all * a * reps, numbers_all, np.eye(3) * a * reps, pbc=True)


@pytest.fixture
def nacl_frame():
    """Rock-salt NaCl conventional cell scaled so Na-Cl distance = 2.0 Å.
    NB: nearest-neighbor distance equals half the cell — fine for the
    image-enumerating host engine, NOT for min-image kernels."""
    return _nacl()


@pytest.fixture
def nacl_supercell_frame():
    """2x2x2 NaCl supercell (64 atoms): Na-Cl = 2.0 Å << half cell 4.0 Å,
    safe for minimum-image device kernels."""
    return _nacl(reps=2)


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test when there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a "
                    "machine with the card)")
