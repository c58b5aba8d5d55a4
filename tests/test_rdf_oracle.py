"""RDF pair histograms of the XLA pair engine against the float64
brute-force reference (amof_tpu.oracle): orthorhombic and triclinic
cells, padded species layouts, chunk sizes, the atom-sharded i-range,
frame weights and the fused pipeline."""

import numpy as np
import pytest

from amof_tpu import oracle
from amof_tpu.core import cellmath
from amof_tpu.ops import pair_engine


def _case(n, box, n_species, seed, pad_from=None):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    cell = (np.eye(3) * box).astype(np.float32)
    sp = rng.integers(0, n_species, n).astype(np.int32)
    if pad_from is not None:
        sp[pad_from:] = -1
    return pos, cell, sp


def _triclinic(seed, n=256, n_species=2):
    rng = np.random.default_rng(seed)
    cell = cellmath.cellpar_to_cell([11, 12, 13, 80, 95, 101]).astype(
        np.float32
    )
    pos = (rng.uniform(0, 1, (n, 3)) @ cell).astype(np.float32)
    sp = rng.integers(0, n_species, n).astype(np.int32)
    return pos, cell, sp


def _assert_matches_oracle(got, pos, cell, sp, dr, s, bins):
    ref, near = oracle.rdf_counts(pos, cell, sp, s, dr, bins)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    assert oracle.cumulative_excess(got, ref, near) <= 0
    assert abs(got.sum() - ref.sum()) <= near[..., -1].sum()
    assert ref.sum() > 0


class TestRdfAgainstOracle:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_oracle(self, seed):
        pos, cell, sp = _case(512, 12.0, 3, seed, pad_from=500)
        got = pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.05, 3, 120, chunk=256
        )
        _assert_matches_oracle(got, pos, cell, sp, 0.05, 3, 120)

    def test_triclinic_cell(self):
        pos, cell, sp = _triclinic(3)
        got = pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.1, 2, 50, chunk=256
        )
        _assert_matches_oracle(got, pos, cell, sp, 0.1, 2, 50)

    def test_pad_rows_count_nothing(self):
        """Trailing pad rows leave the histogram of the real atoms."""
        pos, cell, sp = _case(256, 10.0, 2, 5)
        padded_pos, padded_sp = pair_engine.pad_atoms(pos, sp, 384)
        assert len(padded_sp) == 384
        full = np.asarray(pair_engine.frame_rdf_counts(
            padded_pos, cell, padded_sp, 0.1, 2, 50, chunk=128))
        bare = np.asarray(pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.1, 2, 50, chunk=128))
        assert np.array_equal(full, bare)


class TestRdfLayouts:
    def test_interleaved_pad_rows(self):
        """Pad rows (species -1) anywhere in the atom axis, as a
        species-grouped layout leaves them, count nothing."""
        rng = np.random.default_rng(9)
        n, box, s = 512, 12.0, 3
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        cell = (np.eye(3) * box).astype(np.float32)
        sp = np.sort(rng.integers(0, s, n)).astype(np.int32)
        sp[rng.choice(n, 60, replace=False)] = -1
        got = pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.05, s, 120, chunk=128
        )
        _assert_matches_oracle(got, pos, cell, sp, 0.05, s, 120)

    @pytest.mark.parametrize("chunk", [32, 64, 128])
    def test_chunk_sizes(self, chunk):
        pos, cell, sp = _case(384, 10.0, 2, 21)
        got = pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.05, 2, 120, chunk=chunk
        )
        _assert_matches_oracle(got, pos, cell, sp, 0.05, 2, 120)

    def test_diagonal_cell(self):
        pos, cell, sp = _case(384, 10.0, 2, 31)
        sc = np.asarray(pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.05, 2, 120, chunk=128
        ))
        _assert_matches_oracle(sc, pos, cell, sp, 0.05, 2, 120)

    @pytest.mark.parametrize("triclinic", [False, True])
    def test_pipeline_rdf_matches_oracle(self, triclinic):
        """FusedAnalysis on diagonal and triclinic cells: the
        volume-weighted frame sum equals the reference counts."""
        from amof_tpu.core.frames import FrameBatch
        from amof_tpu.parallel.mesh import analysis_mesh
        from amof_tpu.parallel.pipeline import FusedAnalysis

        rng = np.random.default_rng(5)
        cell = np.eye(3, dtype=np.float32) * 10.0
        if triclinic:
            cell[1, 0] = 0.8
        frac = rng.uniform(0, 1, (2, 96, 3))
        pos = (frac @ cell).astype(np.float32)
        z = np.array([6] * 48 + [1] * 48, np.int32)
        batch = FrameBatch(pos, np.tile(cell, (2, 1, 1)), z,
                           np.arange(2, dtype=np.int32))
        fa = FusedAnalysis({"C-C": 1.7}, dr=0.1, rmax=4.5, dtheta=2.0,
                           chunk=32, with_bad=False, with_msd=False)
        out, meta = fa.run(batch, mesh=analysis_mesh(1))
        volume = abs(float(np.linalg.det(cell.astype(np.float64))))
        got = np.rint(out["rdf_counts"] / volume)
        sp = (z == 6).astype(np.int32)  # unique = [1, 6]
        ref = sum(oracle.rdf_counts(pos[f], cell, sp, 2, 0.1, meta["bins"])[0]
                  for f in range(2))
        near = sum(oracle.rdf_counts(pos[f], cell, sp, 2, 0.1,
                                     meta["bins"])[1] for f in range(2))
        assert oracle.cumulative_excess(got, ref, near) <= 0

    def test_production_bins(self):
        """dr = 0.01 (the reference default) over ~1500 bins."""
        pos, cell, sp = _case(384, 30.0, 2, 22)
        got = pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.01, 2, 1368, chunk=128
        )
        _assert_matches_oracle(got, pos, cell, sp, 0.01, 2, 1368)

    @pytest.mark.parametrize("block", [64, 1000])
    def test_onehot_histogram_blocks(self, block):
        """The one-hot histogram equals bincount for any block size,
        including blocks that do not divide the key count; the sentinel
        key ``total`` is dropped."""
        import jax.numpy as jnp

        rng = np.random.default_rng(7)
        total = 700
        k = rng.integers(0, total + 1, 5000).astype(np.int32)
        w = (rng.random(5000) < 0.8).astype(np.float32)
        got = np.asarray(pair_engine._onehot_histogram(
            jnp.asarray(k), jnp.asarray(w), total, block=block
        ))
        want = np.bincount(k, weights=w, minlength=total + 1)[:total]
        np.testing.assert_array_equal(got, want)

    def test_atom_sharded_slices_sum_to_full(self):
        """Dynamic i-range slices (the 'atoms' mesh axis) add up to
        the full static pass and to the reference."""
        import jax.numpy as jnp

        pos, cell, sp = _case(256, 10.0, 2, 4)
        full = np.asarray(pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.1, 2, 50, chunk=64
        ))
        parts = sum(
            np.asarray(pair_engine.frame_rdf_counts(
                pos, cell, sp, 0.1, 2, 50, chunk=64,
                i_start=jnp.int32(i0), n_i=128,
            ))
            for i0 in (0, 128)
        )
        assert np.array_equal(full, parts)
        _assert_matches_oracle(full, pos, cell, sp, 0.1, 2, 50)

    def test_trajectory_weighted_frames(self):
        """trajectory_rdf_counts weights each frame (the per-frame
        volume of NPT runs) and sums over triclinic frames."""
        pos0, cell, sp = _triclinic(13)
        pos1, _, _ = _triclinic(14)
        w = np.array([2.0, 3.0], np.float32)
        got = np.asarray(pair_engine.trajectory_rdf_counts(
            np.stack([pos0, pos1]), np.stack([cell, cell]), sp, 0.1, 2, 50,
            chunk=128, frame_weights=w))
        refs = [oracle.rdf_counts(p, cell, sp, 2, 0.1, 50)
                for p in (pos0, pos1)]
        ref = 2.0 * refs[0][0] + 3.0 * refs[1][0]
        near = 3.0 * (refs[0][1] + refs[1][1])
        assert oracle.cumulative_excess(got, ref, near) <= 0
