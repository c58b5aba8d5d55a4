"""CN and BAD tests: exact lattice oracles + cross-validation against an
independent host implementation of the reference semantics."""

import itertools

import numpy as np
import pytest

import amof_tpu.atom as amatom
import amof_tpu.bad as ambad
import amof_tpu.cn as amcn
import amof_tpu.species as amspecies
from amof_tpu.core.frames import Frame


class TestCoordinationNumber:
    def test_simple_cubic(self, simple_cubic_frame):
        cn = amcn.CoordinationNumber.from_trajectory(
            [simple_cubic_frame] * 3, {"Ar-Ar": 2.5}, delta_Step=10
        )
        assert list(cn.data.columns) == ["Step", "Ar-Ar"]
        assert np.array_equal(cn.data["Step"], [0, 10, 20])
        assert np.allclose(cn.data["Ar-Ar"], 6.0)

    def test_nacl_both_directions(self, nacl_supercell_frame):
        cn = amcn.CoordinationNumber.from_trajectory(
            [nacl_supercell_frame], {"Na-Cl": 2.2, "Cl-Na": 2.2}
        )
        assert cn.data["Na-Cl"][0] == pytest.approx(6.0)
        assert cn.data["Cl-Na"][0] == pytest.approx(6.0)

    def test_zif4_zn_n(self, zif4_frame):
        cn = amcn.CoordinationNumber.from_trajectory(
            [zif4_frame], {"Zn-N": 2.5, "C-H": 1.35}
        )
        assert cn.data["Zn-N"][0] == pytest.approx(4.0)

    def test_matches_host_engine(self):
        """Device CN == host neighbor-list CN (reference semantics) on a
        random disordered frame."""
        rng = np.random.default_rng(42)
        frame = Frame(
            rng.uniform(0, 8, (60, 3)),
            rng.choice([8, 14], 60),
            np.eye(3) * 8.0,
        )
        spec = {"Si-O": 2.0, "O-O": 1.5}
        cn = amcn.CoordinationNumber.from_trajectory([frame], spec)

        # independent host computation following amof/cn.py:58-73
        cutoff_dict = amatom.format_cutoff(spec)
        nl = amatom.get_neighborlist(frame, cutoff_dict)
        numbers = frame.get_atomic_numbers()
        for nb_set in spec:
            a, b = (
                {"Si": 14, "O": 8}[s] for s in nb_set.split("-")
            )
            cn_list = [
                np.sum(numbers[nl[i]] == b)
                for i in range(len(frame))
                if numbers[i] == a
            ]
            assert cn.data[nb_set][0] == pytest.approx(np.mean(cn_list))

    def test_file_roundtrip(self, tmp_path, simple_cubic_frame):
        cn = amcn.CoordinationNumber.from_trajectory(
            [simple_cubic_frame], {"Ar-Ar": 2.5}
        )
        cn.write_to_file(tmp_path / "t")
        back = amcn.CoordinationNumber.from_file(tmp_path / "t")
        assert np.allclose(back.data, cn.data)


def host_bad_reference(frames, nb_set_and_cutoff, dtheta):
    """Independent host implementation of the reference BAD semantics
    (amof/bad.py:71-160) used as oracle: neighbor lists + min-image
    angles + one density histogram over all frames."""
    from amof_tpu.data import elements as el

    cutoff_dict = amatom.format_cutoff(nb_set_and_cutoff)
    unique = sorted(set(frames[0].get_atomic_numbers().tolist()))
    present = sorted(
        {el.atomic_numbers[s] for k in nb_set_and_cutoff for s in k.split("-")}
    )
    epu = list(present)
    if len(epu) == len(unique):
        epu.append("X")
    pairs = [
        (a, b) for b in epu for a in epu
        if (a not in [b, "X"] or ((a, b) == ("X", "X")))
    ]
    bins = int(180 // dtheta)
    theta_bins = np.arange(bins + 2) * dtheta
    out = {}
    for A, B in pairs:
        sym = lambda x: "X" if x == "X" else el.symbol_of(x)
        name = "-".join([sym(B), sym(A), sym(B)])
        angles = []
        for frame in frames:
            nl = amatom.get_neighborlist(frame, cutoff_dict)
            numbers = frame.get_atomic_numbers()
            for a_idx in range(len(numbers)):
                if A == "X" or numbers[a_idx] == A:
                    nbrs = [
                        j for j in nl[a_idx] if B == "X" or numbers[j] == B
                    ]
                    triplets = [
                        [i, a_idx, j] for i, j in itertools.combinations(nbrs, 2)
                    ]
                    if triplets:
                        angles += list(frame.get_angles(triplets, mic=True))
        if angles:
            out[name] = np.histogram(angles, bins=theta_bins, density=True)[0]
    return out


class TestBad:
    def test_simple_cubic_angles(self, simple_cubic_frame):
        bad = ambad.Bad.from_trajectory(
            [simple_cubic_frame], {"Ar-Ar": 2.5}, dtheta=1.0
        )
        d = bad.data
        col = "X-X-X"
        assert col in d.columns
        # peaks at 90 (12 pairs/atom) and 180 (3 pairs/atom), ratio 4:1
        v90 = d[col][(d["theta"] > 89) & (d["theta"] < 91)].sum()
        v180 = d[col][d["theta"] > 179].sum()
        assert v90 > 0 and v180 > 0
        assert v90 / v180 == pytest.approx(4.0, rel=1e-3)
        # density normalization: integral over theta == 1
        assert np.sum(d[col]) * 1.0 == pytest.approx(1.0, rel=1e-6)

    def test_matches_host_reference(self):
        rng = np.random.default_rng(7)
        numbers = rng.choice([8, 14], 40)  # species static across frames
        frames = [
            Frame(rng.uniform(0, 7, (40, 3)), numbers, np.eye(3) * 7.0)
            for _ in range(2)
        ]
        spec = {"Si-O": 2.2}
        dtheta = 2.0
        bad = ambad.Bad.from_trajectory(frames, spec, dtheta=dtheta)
        ref = host_bad_reference(frames, spec, dtheta)
        assert set(ref.keys()) <= set(bad.data.columns)
        for name, hist in ref.items():
            assert np.allclose(bad.data[name], hist, atol=1e-6), name

    def test_zif4_tetrahedral(self, zif4_frame):
        bad = ambad.Bad.from_trajectory(
            [zif4_frame], {"Zn-N": 2.5}, dtheta=0.5
        )
        d = bad.data
        assert "N-Zn-N" in d.columns
        # each N bonds exactly one Zn, so no Zn-N-Zn angle exists and the
        # column is dropped (reference drops empty angle lists too,
        # amof/bad.py:159)
        assert "Zn-N-Zn" not in d.columns
        peak_theta = d["theta"][d["N-Zn-N"].idxmax()]
        assert 100 < peak_theta < 120  # tetrahedral ~109.5
        total = d["N-Zn-N"].sum() * 0.5
        assert total == pytest.approx(1.0, rel=1e-6)

    def test_file_roundtrip(self, tmp_path, simple_cubic_frame):
        bad = ambad.Bad.from_trajectory(
            [simple_cubic_frame], {"Ar-Ar": 2.5}, dtheta=1.0
        )
        bad.write_to_file(tmp_path / "t")
        back = ambad.Bad.from_file(tmp_path / "t")
        assert np.allclose(back.data, bad.data)

    @pytest.mark.slow
    def test_overflow_retry(self):
        """Dense cluster exceeding the initial neighbor capacity of 16
        must retry, not truncate."""
        rng = np.random.default_rng(0)
        frame = Frame(
            rng.uniform(0, 4.0, (64, 3)), np.full(64, 18), np.eye(3) * 4.0
        )
        bad = ambad.Bad.from_trajectory([frame], {"Ar-Ar": 2.4}, dtheta=5.0)
        # every atom has ~20+ neighbors; histogram must integrate to 1
        assert np.sum(bad.data["X-X-X"]) * 5.0 == pytest.approx(1.0, rel=1e-6)


class TestBadByCn:
    def test_simple_cubic_single_cn(self, simple_cubic_frame):
        bad = ambad.BadByCn.from_trajectory(
            [simple_cubic_frame], {"Ar-Ar": 2.5}, dtheta=1.0
        )
        arr = bad.data["bad"]
        assert "atom_triple" in arr.dims and "cn" in arr.dims
        assert np.array_equal(arr.get_coord("cn"), [6])
        sub = arr.sel(atom_triple="X-X-X", cn=6)
        assert np.nansum(sub.values) * 1.0 == pytest.approx(1.0, rel=1e-6)

    def test_partial_normalization(self):
        """Two Xe centers with cn 2 and 3: partial weights proportional to
        angle counts (1 vs 3), summing to overall area 1."""
        positions = [
            [2, 2, 2], [4, 2, 2],      # center A (cn 2 incl other center? no - species)
        ]
        # build: center atoms Kr, outer atoms Ar; one Kr with 2 Ar, one with 3
        pos = [[3, 3, 3], [3, 3, 4.2], [3, 3, 1.8],          # Kr + 2 Ar
               [9, 9, 9], [9, 9, 10.2], [9, 9, 7.8], [9, 10.2, 9]]  # Kr + 3 Ar
        numbers = [36, 18, 18, 36, 18, 18, 18]
        frame = Frame(pos, numbers, np.eye(3) * 14.0)
        bad = ambad.BadByCn.from_trajectory(
            [frame], {"Kr-Ar": 1.5}, dtheta=5.0, normalization="partial"
        )
        arr = bad.data["bad"]
        sub = arr.sel(atom_triple="Ar-Kr-Ar")
        assert set(sub.get_coord("cn").tolist()) == {2, 3}
        a2 = np.nansum(sub.sel(cn=2).values) * 5.0
        a3 = np.nansum(sub.sel(cn=3).values) * 5.0
        assert a2 == pytest.approx(0.25, rel=1e-6)  # 1 of 4 angles
        assert a3 == pytest.approx(0.75, rel=1e-6)  # 3 of 4 angles

    def test_netcdf_roundtrip(self, tmp_path, simple_cubic_frame):
        bad = ambad.BadByCn.from_trajectory(
            [simple_cubic_frame], {"Ar-Ar": 2.5}, dtheta=1.0
        )
        bad.write_to_file(tmp_path / "t")
        back = ambad.BadByCn.from_file(tmp_path / "t")
        assert back.data["bad"].allclose(bad.data["bad"], equal_nan=True)


class TestSortedWindowTable:
    """Sorted-window neighbor table (pair_engine
    .frame_neighbor_payload_table_sorted) vs the full O(N^2) table."""

    def _random_system(self, n=640, seed=3):
        import jax.numpy as jnp

        from amof_tpu.species import cutoff_matrix as _cutoff_matrix_for_species
        from amof_tpu.ops import pair_engine
        from amof_tpu.species import species_table as _species_table

        rng = np.random.default_rng(seed)
        species = rng.choice([8, 14, 30], n)
        box = (n / 0.06) ** (1 / 3)
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        unique, z_to_idx = _species_table(species)
        cm = _cutoff_matrix_for_species(
            {"Si-O": 2.0, "Zn-O": 2.2, "Si-Si": 2.4}, unique, z_to_idx
        )
        pos_p, sp = pair_engine.pad_atoms(pos[None], z_to_idx[species], 64)
        cell = jnp.eye(3, dtype=jnp.float32) * box
        return jnp.asarray(pos_p[0]), cell, jnp.asarray(sp), jnp.asarray(cm)

    def test_bad_counts_bit_exact(self):
        """Windowed and full tables give identical angle histograms."""
        from amof_tpu.ops import bad_kernel

        pos, cell, sp, cm = self._random_system()
        kw = dict(n_species=3, dtheta=2.0, bins=91, max_neighbors=8,
                  chunk=64)
        c_full, a_full, ov_full = bad_kernel.frame_bad_counts(
            pos, cell, sp, cm, **kw
        )
        c_win, a_win, ov_win = bad_kernel.frame_bad_counts(
            pos, cell, sp, cm, window=192, **kw
        )
        assert not bool(ov_full) and not bool(ov_win)
        assert np.array_equal(np.asarray(c_full), np.asarray(c_win))
        assert np.array_equal(np.asarray(a_full), np.asarray(a_win))
        assert np.asarray(c_win).sum() > 0  # nontrivial workload

    def test_window_miss_flagged(self):
        """A window too narrow for the density must raise the flag, and
        the exact counts (full-range pass) must still be returned."""
        from amof_tpu.ops import pair_engine

        pos, cell, sp, cm = self._random_system()
        out = pair_engine.frame_neighbor_payload_table_sorted(
            pos, cell, sp, cm, max_neighbors=8, chunk=64, window=1
        )
        nbr_pos, nbr_sp, nbr_cnt, flag, c_pos, c_sp = out
        # the positional coverage check must flag the too-narrow window;
        # counts are NOT trustworthy on a miss (callers fall back)
        assert bool(flag)

    def test_centers_are_permutation(self):
        from amof_tpu.ops import pair_engine

        pos, cell, sp, cm = self._random_system()
        out = pair_engine.frame_neighbor_payload_table_sorted(
            pos, cell, sp, cm, max_neighbors=8, chunk=64, window=192
        )
        _, _, _, flag, c_pos, c_sp = out
        assert not bool(flag)
        assert sorted(np.asarray(c_sp).tolist()) == sorted(
            np.asarray(sp).tolist()
        )
        assert np.allclose(
            np.sort(np.asarray(c_pos), axis=0), np.sort(np.asarray(pos),
                                                        axis=0)
        )

    def test_fused_pipeline_auto_window(self):
        """FusedAnalysis(bad_window='auto') matches bad_window=None."""
        from amof_tpu.core.frames import FrameBatch
        from amof_tpu.parallel.pipeline import FusedAnalysis

        rng = np.random.default_rng(11)
        n, f = 1536, 2
        species = rng.choice([8, 14], n).astype(np.int32)
        box = (n / 0.06) ** (1 / 3)
        pos = rng.uniform(0, box, (f, n, 3)).astype(np.float32)
        cells = np.tile(np.eye(3, dtype=np.float32) * box, (f, 1, 1))
        batch = FrameBatch(pos, cells, species,
                           np.arange(f, dtype=np.int32))
        import jax
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("frames", "atoms"))
        kw = dict(dr=0.1, dtheta=5.0, chunk=128, max_neighbors=8,
                  with_msd=False)
        out_a, _ = FusedAnalysis({"Si-O": 2.0}, bad_window="auto",
                                 **kw).run(batch, mesh=mesh)
        out_n, _ = FusedAnalysis({"Si-O": 2.0}, bad_window=None,
                                 **kw).run(batch, mesh=mesh)
        assert not out_a["bad_overflow"].any()
        for k in ("bad_concrete", "bad_center_any", "rdf_counts",
                  "cn_counts"):
            # cn_counts exercises the emit_cn path (exact integer counts
            # both ways, so equality is exact)
            assert np.array_equal(out_a[k], out_n[k]), k


class TestBadByCnMxuPath:
    def test_mxu_equals_scatter(self, monkeypatch):
        """by_cn histograms via one one-hot pass match the segmented
        passes exactly (segmentation is chosen by key-space size)."""
        import amof_tpu.ops.bad_kernel as bk
        from amof_tpu.species import cutoff_matrix as _cutoff_matrix_for_species
        from amof_tpu.ops import pair_engine
        from amof_tpu.species import species_table as _species_table

        import jax.numpy as jnp

        rng = np.random.default_rng(5)
        n = 256
        species = rng.choice([8, 14], n)
        box = (n / 0.06) ** (1 / 3)
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        unique, z_to_idx = _species_table(species)
        cm = _cutoff_matrix_for_species({"Si-O": 2.2}, unique, z_to_idx)
        pos_p, sp = pair_engine.pad_atoms(pos[None], z_to_idx[species], 64)
        args = (jnp.asarray(pos_p[0]), jnp.eye(3, dtype=jnp.float32) * box,
                jnp.asarray(sp), jnp.asarray(cm))
        kw = dict(n_species=2, dtheta=5.0, bins=37, max_neighbors=8,
                  chunk=64, by_cn=True)
        c_mxu, a_mxu, _ = bk.frame_bad_counts(*args, **kw)
        monkeypatch.setattr(bk, "ONEHOT_SLOT_LIMIT", 1)
        bk.frame_bad_counts.clear_cache()
        c_sc, a_sc, _ = bk.frame_bad_counts(*args, **kw)
        bk.frame_bad_counts.clear_cache()
        assert np.array_equal(np.asarray(c_mxu), np.asarray(c_sc))
        assert np.array_equal(np.asarray(a_mxu), np.asarray(a_sc))
        assert np.asarray(c_mxu).sum() > 0


class TestSegmentedMxuHistogram:
    """Key spaces beyond ONEHOT_SLOT_LIMIT are segmented into bounded
    one-hot passes."""

    def test_matches_bincount(self):
        import jax.numpy as jnp

        from amof_tpu.ops.bad_kernel import _segmented_onehot_histogram

        rng = np.random.default_rng(0)
        total = 1000
        k = rng.integers(0, total + 1, size=(64, 37)).astype(np.int32)
        w = (rng.random((64, 37)) < 0.7).astype(np.float32)
        got = np.asarray(_segmented_onehot_histogram(
            jnp.asarray(k), jnp.asarray(w), total, seg_limit=128
        ))
        want = np.bincount(
            k.reshape(-1), weights=w.reshape(-1), minlength=total + 1
        )[:total]
        np.testing.assert_array_equal(got, want)

    def test_big_by_cn_key_space(self):
        """frame_bad_counts with a CN-resolved key space > the segment
        limit agrees with a small-key-space run on the same geometry."""
        from amof_tpu.ops import bad_kernel

        rng = np.random.default_rng(1)
        n, box = 96, 8.5
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        cell = np.eye(3, dtype=np.float32) * box
        sp = rng.integers(0, 4, n).astype(np.int32)
        cut = np.full((4, 4), 2.6, np.float32)
        # fine bins push 4*4*(24+1)*3601 slots ~ 1.4M > 640k: segmented
        big = bad_kernel.frame_bad_counts(
            pos, cell, sp, cut, 4, 0.05, 3601, max_neighbors=24,
            chunk=32, by_cn=True,
        )
        conc_b, any_b, ovf_b = (np.asarray(v) for v in big)
        assert not ovf_b
        # coarse bins keep the space under one segment: same geometry,
        # totals per (a, b, cn) must match exactly
        small = bad_kernel.frame_bad_counts(
            pos, cell, sp, cut, 4, 1.0, 181, max_neighbors=24,
            chunk=32, by_cn=True,
        )
        conc_s, any_s, ovf_s = (np.asarray(v) for v in small)
        np.testing.assert_array_equal(
            conc_b.sum(axis=-1), conc_s.sum(axis=-1)
        )
        np.testing.assert_array_equal(any_b.sum(axis=-1), any_s.sum(axis=-1))
        assert conc_b.sum() > 0


class TestCellListNeighbors:
    """The O(N) cell-list host search returns the exact pair SET of the
    image-enumerating path (order may differ)."""

    @staticmethod
    def _as_set(out):
        i, j, d, s = out
        return {
            (int(a), int(b), tuple(int(v) for v in sh), round(float(dd), 9))
            for a, b, dd, sh in zip(i, j, d, s)
        }

    @pytest.mark.parametrize("seed,n,box", [(0, 400, 14.0), (1, 700, 17.0)])
    def test_matches_legacy(self, seed, n, box):
        from amof_tpu.ops import neighbors_host as nh

        rng = np.random.default_rng(seed)
        cell = np.eye(3) * box
        cell[1, 0] = 1.5  # triclinic
        frac = rng.random((n, 3))
        pos = frac @ cell  # home cell: both paths see every image
        legacy = nh.neighbor_pairs(pos, cell, True, 3.1, _force="legacy")
        fast = nh.neighbor_pairs(pos, cell, True, 3.1, _force="celllist")
        assert self._as_set(legacy) == self._as_set(fast)
        assert len(legacy[0]) > 0

    def test_raw_positions_superset(self):
        """With positions far outside the home cell the legacy image
        enumeration (sized from the cutoff only) MISSES genuine pairs;
        the cell list wraps per atom and finds a superset."""
        from amof_tpu.ops import neighbors_host as nh

        rng = np.random.default_rng(0)
        n, box = 400, 14.0
        cell = np.eye(3) * box
        pos = rng.uniform(-box, 2 * box, (n, 3))
        legacy = self._as_set(
            nh.neighbor_pairs(pos, cell, True, 3.1, _force="legacy")
        )
        fast = self._as_set(
            nh.neighbor_pairs(pos, cell, True, 3.1, _force="celllist")
        )
        assert legacy <= fast and len(fast) > len(legacy)

    def test_matches_legacy_cutoff_matrix(self):
        from amof_tpu.ops import neighbors_host as nh

        rng = np.random.default_rng(2)
        n, box = 500, 15.0
        cell = np.eye(3) * box
        pos = rng.uniform(0, box, (n, 3))
        sp = rng.integers(0, 3, n)
        cm = np.array([[2.0, 2.8, 0.0], [2.8, 1.5, 2.2], [0.0, 2.2, 3.0]])
        legacy = nh.neighbor_pairs(pos, cell, True, cm, species=sp,
                                   _force="legacy")
        fast = nh.neighbor_pairs(pos, cell, True, cm, species=sp,
                                 _force="celllist")
        assert self._as_set(legacy) == self._as_set(fast)
        assert len(legacy[0]) > 0


class TestWindowedCnClass:
    def test_matches_full_pass_large_system(self):
        """At >= 2048 atoms CoordinationNumber rides the O(N*W)
        sorted-window pass; counts must equal the O(N^2) pass."""
        import jax

        from amof_tpu.core.frames import FrameBatch
        from amof_tpu.ops import pair_engine
        from amof_tpu.species import species_table as _species_table

        rng = np.random.default_rng(5)
        n, box, nf = 2560, 34.0, 2
        species = np.concatenate(
            [np.full(n // 4, 30), np.full(3 * n // 4, 7)]
        ).astype(np.int32)
        pos = rng.uniform(0, box, (nf, n, 3)).astype(np.float32)
        cells = np.tile(np.eye(3, dtype=np.float32) * box, (nf, 1, 1))
        batch = FrameBatch(pos, cells, species, np.arange(nf, dtype=np.int32))

        cn = amcn.CoordinationNumber.from_trajectory(
            batch, {"Zn-N": 2.8, "N-N": 2.2}
        )
        # oracle: full-pass counts through the same normalization
        unique, z_to_idx = _species_table(species)
        cmat = amspecies.cutoff_matrix(
            {"Zn-N": 2.8, "N-N": 2.2}, unique, z_to_idx
        )
        p_pad, sp_pad = pair_engine.pad_atoms(pos, z_to_idx[species])
        full = np.asarray(jax.lax.map(
            lambda a: pair_engine.frame_cn_counts(
                a[0], a[1], sp_pad, cmat, len(unique), 256
            ),
            (p_pad, cells),
        ))
        n_zn = (species == 30).sum()
        n_n = (species == 7).sum()
        iz, inn = int(z_to_idx[30]), int(z_to_idx[7])
        np.testing.assert_allclose(
            cn.data["Zn-N"], full[:, iz, inn] / n_zn, rtol=1e-6
        )
        np.testing.assert_allclose(
            cn.data["N-N"], full[:, inn, inn] / n_n, rtol=1e-6
        )


class TestCnWindowMissFallback:
    def test_class_survives_window_miss(self):
        """CoordinationNumber.from_trajectory on a system engineered to
        miss the sorted window (all atoms in a thin x-slab of a large
        box, >= 2048 atoms, CPU backend) must fall back to the exact
        per-frame pass instead of crashing on a read-only numpy view of
        the JAX counts array (ADVICE r2, amof_tpu/cn.py)."""
        from amof_tpu.core.frames import FrameBatch

        rng = np.random.default_rng(11)
        n, box = 2048, 100.0
        species = np.concatenate(
            [np.full(n // 4, 30), np.full(3 * n // 4, 7)]
        ).astype(np.int32)
        pos = rng.uniform(0, box, (1, n, 3)).astype(np.float32)
        pos[..., 0] = rng.uniform(0.48 * box, 0.52 * box, (1, n))
        cells = np.tile(np.eye(3, dtype=np.float32) * box, (1, 1, 1))
        batch = FrameBatch(pos, cells, species, np.zeros(1, np.int32))
        cn = amcn.CoordinationNumber.from_trajectory(batch, {"Zn-N": 2.8})
        # oracle: brute-force count of N within 2.8 of each Zn
        d = pos[0, :, None, :] - pos[0, None, :, :]
        d -= box * np.round(d / box)
        dist = np.sqrt((d ** 2).sum(-1))
        zn = species == 30
        nn = species == 7
        expect = (dist[zn][:, nn] < 2.8).sum() / zn.sum()
        np.testing.assert_allclose(cn.data["Zn-N"], expect, rtol=1e-6)


class TestBadClassAutoWindow:
    def test_windowed_equals_full_large_system(self):
        """Bad and BadByCn on a >= 2048-atom system (auto-window path)
        equal the forced full-table run bit for bit."""
        from amof_tpu.core.frames import FrameBatch
        from amof_tpu.ops import bad_kernel
        from amof_tpu.species import species_table as _species_table
        from amof_tpu.ops import pair_engine

        rng = np.random.default_rng(9)
        n, box, nf = 2304, 32.0, 2
        species = np.concatenate(
            [np.full(n // 4, 30), np.full(3 * n // 4, 7)]
        ).astype(np.int32)
        pos = rng.uniform(0, box, (nf, n, 3)).astype(np.float32)
        cells = np.tile(np.eye(3, dtype=np.float32) * box, (nf, 1, 1))
        batch = FrameBatch(pos, cells, species, np.arange(nf, dtype=np.int32))
        cut = {"Zn-N": 2.8, "N-N": 2.4}

        bad = ambad.Bad.from_trajectory(batch, cut, dtheta=1.0)
        # oracle: full-table counts through the kernel directly
        unique, z_to_idx = _species_table(species)
        cmat = amspecies.cutoff_matrix(cut, unique, z_to_idx)
        p_pad, sp_pad = pair_engine.pad_atoms(pos, z_to_idx[species])
        conc, any_, ovf = bad_kernel.trajectory_bad_counts(
            p_pad, cells, sp_pad, cmat, len(unique), 1.0, 181, 16, 256,
            window=None,
        )
        assert not bool(ovf)
        # rebuild the class's density-normalized columns from the
        # window=None oracle counts and compare (this genuinely
        # verifies the auto-windowed path against the full table; a
        # second identical class run would compare the windowed run to
        # itself)
        pairs, names = amspecies.bad_specs(cut, unique)
        specs = [
            (
                -1 if a == "X" else int(z_to_idx[a]),
                -1 if b == "X" else int(z_to_idx[b]),
            )
            for a, b in pairs
        ]
        conc64 = np.asarray(conc, np.float64)
        any64 = np.asarray(any_, np.float64)
        checked = 0
        for s, name in zip(specs, names):
            hist = np.asarray(
                bad_kernel.select_spec_counts(conc64, any64, s)
            ).sum(axis=0)
            total = hist.sum()
            if name in bad.data.columns:
                assert total > 0, name
                np.testing.assert_allclose(
                    bad.data[name], hist / (total * 1.0), rtol=1e-6,
                    err_msg=name,
                )
                checked += 1
        assert checked >= 2
        by_cn = ambad.BadByCn.from_trajectory(batch, cut, dtheta=1.0)
        # empty (triple, cn) groups normalize to NaN by design
        assert float(np.nansum(np.asarray(
            list(by_cn.data.data_vars.values())[0].values
        ))) > 0
