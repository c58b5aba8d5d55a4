"""RDF tests against analytic oracles (SURVEY.md §4): ideal-gas g=1,
exact lattice neighbor counts, partial selectivity, file round-trip."""

import numpy as np
import pytest

import amof_tpu.rdf as amrdf
from amof_tpu.core.frames import Frame
from amof_tpu.ops import pair_engine


def ideal_gas_frames(n_atoms=200, n_frames=10, box=12.0, seed=0):
    rng = np.random.default_rng(seed)
    return [
        Frame(rng.uniform(0, box, (n_atoms, 3)), np.full(n_atoms, 18),
              np.eye(3) * box)
        for _ in range(n_frames)
    ]


class TestPairEngine:
    def test_sc_lattice_exact_counts(self, simple_cubic_frame):
        """64-atom SC lattice, a=2: exactly 6 ordered pairs/atom in the
        first shell, 12 in the second."""
        f = simple_cubic_frame
        positions, species_idx = pair_engine.pad_atoms(
            f.positions.astype(np.float32), np.zeros(len(f), np.int32)
        )
        counts = np.asarray(pair_engine.frame_rdf_counts(
            positions, f.cell.astype(np.float32), species_idx,
            0.3, 1, 13, chunk=256,
        ))
        # bin of d=2.0 at dr=0.3 -> floor(2.0/0.3) = 6
        assert counts[0, 0, 6] == 64 * 6
        # second neighbors at 2*sqrt(2)=2.828 -> bin 9
        assert counts[0, 0, 9] == 64 * 12
        # no pairs below first shell
        assert counts[0, 0, :6].sum() == 0

    def test_mxu_matches_scatter(self, nacl_supercell_frame):
        f = nacl_supercell_frame
        sp = (f.numbers == 17).astype(np.int32)
        positions, species_idx = pair_engine.pad_atoms(
            f.positions.astype(np.float32), sp
        )
        args = (positions, f.cell.astype(np.float32), species_idx, 0.05, 2, 50)
        scatter = np.asarray(
            pair_engine.frame_rdf_counts(*args, chunk=256)
        )
        # the one-hot histogram helper (the BAD kernel's) bins the same
        # keys identically
        import jax.numpy as jnp

        keys = np.repeat(np.arange(scatter.size), scatter.ravel().astype(int))
        onehot = np.asarray(pair_engine._onehot_histogram(
            jnp.asarray(keys, jnp.int32), jnp.ones(len(keys), jnp.float32),
            scatter.size,
        )).reshape(scatter.shape)
        assert np.array_equal(scatter, onehot)
        # Na-Cl first shell: 6 neighbors each, 32 Na atoms -> 192 ordered pairs
        b = int(2.0 / 0.05)
        assert scatter[0, 1, b - 1 : b + 2].sum() == 192

    def test_neighbor_table(self, simple_cubic_frame):
        f = simple_cubic_frame
        positions, species_idx = pair_engine.pad_atoms(
            f.positions.astype(np.float32), np.zeros(len(f), np.int32)
        )
        cutoff = np.array([[2.5]], np.float32)
        idx, cnt, overflow = pair_engine.frame_neighbor_table(
            positions, f.cell.astype(np.float32), species_idx, cutoff,
            max_neighbors=8, chunk=256,
        )
        idx, cnt = np.asarray(idx), np.asarray(cnt)
        assert not bool(overflow)
        assert np.all(cnt[:64] == 6)
        assert np.all(cnt[64:] == 0)  # padding has no neighbors
        # slots beyond cnt hold the sentinel (padded n)
        assert np.all(idx[0, 6:] == positions.shape[0])

    def test_neighbor_table_overflow_flag(self, simple_cubic_frame):
        f = simple_cubic_frame
        positions, species_idx = pair_engine.pad_atoms(
            f.positions.astype(np.float32), np.zeros(len(f), np.int32)
        )
        cutoff = np.array([[2.5]], np.float32)
        _, _, overflow = pair_engine.frame_neighbor_table(
            positions, f.cell.astype(np.float32), species_idx, cutoff,
            max_neighbors=4, chunk=256,
        )
        assert bool(overflow)


class TestRdf:
    def test_ideal_gas_is_flat(self):
        rdf = amrdf.Rdf.from_trajectory(ideal_gas_frames(), dr=0.2)
        data = rdf.data
        far = data["r"] > 2.0
        assert abs(data["X-X"][far].mean() - 1.0) < 0.05
        assert abs(data["Ar-Ar"][far].mean() - 1.0) < 0.05
        assert abs(data["Ar-X"][far].mean() - 1.0) < 0.05

    def test_half_cell_rule_and_binning(self):
        frames = ideal_gas_frames(n_atoms=20, n_frames=2, box=10.0)
        rdf = amrdf.Rdf.from_trajectory(frames, dr=0.07)
        bins = int(5.0 // 0.07)
        assert len(rdf.data) == bins
        assert np.allclose(rdf.data["r"], np.arange(bins) * 0.07)
        # explicit rmax beyond half cell is clamped
        rdf2 = amrdf.Rdf.from_trajectory(frames, dr=0.07, rmax=8.0)
        assert len(rdf2.data) == bins

    def test_partial_columns_and_selectivity(self, nacl_supercell_frame):
        rdf = amrdf.Rdf.from_trajectory([nacl_supercell_frame], dr=0.05)
        cols = set(rdf.data.columns)
        assert {"r", "X-X", "Na-Na", "Na-Cl", "Cl-Na", "Cl-Cl",
                "Na-X", "Cl-X"} <= cols
        # no Na-Na pair below 2.8 A; Na-Cl peak at 2.0
        below = rdf.data["r"] < 2.5
        assert rdf.data["Na-Na"][below].sum() == 0
        peak = rdf.data["Na-Cl"][(rdf.data["r"] > 1.8) & (rdf.data["r"] < 2.1)]
        assert peak.sum() > 0
        # A-X is the row sum of partials
        assert np.allclose(
            rdf.data["Na-X"], rdf.data["Na-Na"] + rdf.data["Na-Cl"]
        )

    def test_normalization_exact_two_atoms(self):
        """Two atoms at distance 2 in a 10^3 box: the single pair lands in
        one bin with g = C*V / (N_sel*N*v_shell)."""
        f = Frame([[0, 0, 0], [2, 0, 0]], [18, 18], np.eye(3) * 10)
        dr = 0.3
        rdf = amrdf.Rdf.from_trajectory([f], dr=dr)
        b = int(2.0 // dr)
        v_shell = 4 * np.pi / 3 * (((b + 1) * dr) ** 3 - (b * dr) ** 3)
        expected = 2 * 1000.0 / (2 * 2 * v_shell)  # 2 ordered pairs
        assert rdf.data["X-X"][b] == pytest.approx(expected, rel=1e-5)
        assert rdf.data["X-X"].drop(index=b).sum() == 0

    def test_coordination_number_ideal_gas(self):
        frames = ideal_gas_frames(n_atoms=300, n_frames=5, box=12.0, seed=3)
        rdf = amrdf.Rdf.from_trajectory(frames, dr=0.05)
        rho = 300 / 12.0**3
        cutoff = 3.0
        cn = rdf.get_coordination_number("X-X", cutoff, rho)
        assert cn == pytest.approx(4 / 3 * np.pi * rho * cutoff**3, rel=0.1)

    def test_file_roundtrip(self, tmp_path, nacl_supercell_frame):
        rdf = amrdf.Rdf.from_trajectory([nacl_supercell_frame], dr=0.1)
        rdf.write_to_file(tmp_path / "test")
        back = amrdf.Rdf.from_file(tmp_path / "test")
        assert np.allclose(back.data, rdf.data)
        assert list(back.data.columns) == list(rdf.data.columns)

    def test_zif4(self, zif4_frame):
        rdf = amrdf.Rdf.from_trajectory([zif4_frame], dr=0.05)
        data = rdf.data
        assert {"X-X", "Zn-N", "C-H", "Zn-X"} <= set(data.columns)
        # Zn-N first coordination shell around 2.0 A
        first_peak_r = data["r"][data["Zn-N"].idxmax()]
        assert 1.8 < first_peak_r < 2.2
        # total g(r) tends to ~1 at large r
        far = data["r"] > 6.0
        assert abs(data["X-X"][far].mean() - 1.0) < 0.15

    def test_rdf_integral_cn_class(self, nacl_supercell_frame):
        cn = amrdf.CoordinationNumber.from_trajectory(
            [nacl_supercell_frame, nacl_supercell_frame], {"Na-Cl": 2.4}, dr=0.001
        )
        assert len(cn.data) == 2
        # Simpson on a single-bin spike carries a parity weight (2/3 or
        # 4/3) — the documented numerical weakness of this deprecated
        # path ("Subjected to numerical errors in the integration step").
        assert 6.0 * 2 / 3 * 0.99 < cn.data["Na-Cl"][0] < 6.0 * 4 / 3 * 1.01
        assert cn.data["Na-Cl"][0] == pytest.approx(cn.data["Na-Cl"][1])


class TestNptRdf:
    def test_variable_cell_normalization(self):
        """NPT: the same relative structure at two different volumes must
        give the same g(r) peak positions scaled with the cell, and the
        per-frame volume weighting must keep the ideal-gas tail at 1."""
        rng = np.random.default_rng(11)
        frac = rng.uniform(0, 1, (150, 3))
        frames = []
        for scale in [10.0, 10.0, 12.0, 12.0, 11.0]:
            frames.append(
                Frame(frac * scale, np.full(150, 18), np.eye(3) * scale)
            )
        rdf = amrdf.Rdf.from_trajectory(frames, dr=0.2)
        far = rdf.data["r"] > 3.0
        assert abs(rdf.data["X-X"][far].mean() - 1.0) < 0.08
