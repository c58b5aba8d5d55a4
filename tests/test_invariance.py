"""Physical invariances of the analysis kernels.

Histograms of a periodic system must be invariant under atom
re-ordering (within a species), rigid translation, wrapping positions
by whole lattice vectors, and relabeling the origin — the failure
modes of minimum-image and padding bugs that golden tests on one
fixture can miss.
"""

import numpy as np
import pytest

from amof_tpu.core.frames import FrameBatch
from amof_tpu.parallel.pipeline import FusedAnalysis
from amof_tpu.parallel.mesh import analysis_mesh


def _batch(rng, n_frames=2, n_atoms=96, box=11.0, triclinic=False):
    cell = np.eye(3, dtype=np.float32) * box
    if triclinic:
        cell[1, 0] = 2.0
        cell[2, 0] = 1.0
        cell[2, 1] = 1.5
    species = np.array([30] * 16 + [7] * 32 + [6] * 48, np.int32)
    frac = rng.random((n_frames, n_atoms, 3)).astype(np.float32)
    pos = frac @ cell
    return FrameBatch(
        pos, np.tile(cell, (n_frames, 1, 1)), species,
        np.arange(n_frames, dtype=np.int32),
    )


def _run(batch):
    fa = FusedAnalysis(
        {"Zn-N": 2.5, "C-N": 1.7, "C-C": 1.8}, dr=0.1, dtheta=2.0,
        chunk=32, with_bad=True, with_msd=False,
        max_neighbors=24,
    )
    out, _ = fa.run(batch, mesh=analysis_mesh(1))
    assert not out["bad_overflow"].any()
    return out


HIST_KEYS = ("rdf_counts", "cn_counts", "bad_concrete", "bad_center_any")


def _assert_same(a, b, context):
    for key in HIST_KEYS:
        np.testing.assert_allclose(
            a[key], b[key], rtol=1e-5, atol=1e-5,
            err_msg=f"{key} not invariant under {context}",
        )


@pytest.mark.parametrize("triclinic", [False, True])
class TestInvariance:
    def test_translation(self, triclinic):
        rng = np.random.default_rng(0)
        batch = _batch(rng, triclinic=triclinic)
        base = _run(batch)
        shift = np.array([1.7, -3.1, 0.9], np.float32)
        moved = batch._replace(positions=batch.positions + shift)
        _assert_same(base, _run(moved), "rigid translation")

    def test_lattice_wrap(self, triclinic):
        rng = np.random.default_rng(1)
        batch = _batch(rng, triclinic=triclinic)
        base = _run(batch)
        # push every atom by a random integer combination of lattice
        # vectors (positions leave the home cell entirely)
        k = rng.integers(-2, 3, batch.positions.shape[:-1] + (3,))
        wrapped = batch._replace(
            positions=(
                batch.positions
                + np.einsum("fnk,fkj->fnj", k.astype(np.float32), batch.cell)
            )
        )
        _assert_same(base, _run(wrapped), "whole-lattice-vector wrap")

    def test_within_species_permutation(self, triclinic):
        rng = np.random.default_rng(2)
        batch = _batch(rng, triclinic=triclinic)
        base = _run(batch)
        # permute atoms within each species block (species stays sorted)
        perm = np.arange(batch.num_atoms)
        species = np.asarray(batch.species)
        for z in np.unique(species):
            idx = np.nonzero(species == z)[0]
            perm[idx] = rng.permutation(idx)
        permuted = batch._replace(positions=batch.positions[:, perm])
        _assert_same(base, _run(permuted), "within-species permutation")


def test_rigid_rotation():
    """Rotating positions AND cell by one orthogonal matrix preserves
    every distance, so all histograms must match (no kernel may assume
    axis-aligned or upper-triangular cells)."""
    rng = np.random.default_rng(3)
    batch = _batch(rng, triclinic=True)
    base = _run(batch)
    # random rotation via QR of a gaussian matrix
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = (q * np.sign(np.diag(r))).astype(np.float32)  # det +1-ish, orthogonal
    rotated = batch._replace(
        positions=batch.positions @ q, cell=batch.cell @ q
    )
    _assert_same(base, _run(rotated), "rigid rotation")
