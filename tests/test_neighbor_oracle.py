"""Sorted-window neighbor table (the BAD/CN table) against float64
brute-force neighbor sets: window sizing, coverage of every centre,
exact sets on orthorhombic, padded and triclinic cells, the coverage
and capacity flags, and the window -> full-table retry ladder."""

import numpy as np
import pytest

from amof_tpu import oracle
from amof_tpu.core import cellmath
from amof_tpu.ops import bad_kernel, pair_engine


def _case(n, box, n_species, seed, pad_from=None, triclinic=False):
    rng = np.random.default_rng(seed)
    if triclinic:
        cell = cellmath.cellpar_to_cell(
            [box, box * 1.07, box * 0.93, 82, 94, 100]
        ).astype(np.float32)
    else:
        cell = (np.eye(3) * box).astype(np.float32)
    pos = (rng.uniform(0, 1, (n, 3)) @ cell).astype(np.float32)
    sp = rng.integers(0, n_species, n).astype(np.int32)
    if pad_from is not None:
        sp[pad_from:] = -1
        pos[pad_from:] = 0.0
    return pos, cell, sp


def _cutoffs(s, seed):
    rng = np.random.default_rng(seed + 100)
    cm = rng.uniform(1.2, 2.1, (s, s)).astype(np.float32)
    return ((cm + cm.T) / 2).astype(np.float32)


def _oracle_sets(pos, cell, sp, cm):
    """({i: certain neighbor set}, {i: neighbors within 1e-5 Å of the
    cutoff}) from the float64 reference."""
    i, j, _, _, unc = oracle.neighbor_pairs(pos, cell, sp, cm)
    sure = {int(a): set() for a in np.nonzero(sp >= 0)[0]}
    loose = {a: set() for a in sure}
    for a, b, u in zip(i.tolist(), j.tolist(), unc.tolist()):
        (loose if u else sure)[a].add(b)
    return sure, loose


def _table(pos, cell, sp, cm, **kw):
    import jax.numpy as jnp

    return pair_engine.frame_neighbor_payload_table_sorted(
        *map(jnp.asarray, (pos, cell, sp, cm)), **kw
    )


def _window_sets(pos, cell, sp, cm, window, k=16, chunk=64):
    out = _table(pos, cell, sp, cm, max_neighbors=k, chunk=chunk,
                 window=window)
    nbr_pos, nbr_sp, cnt, flag, c_pos, c_sp = map(np.asarray, out)
    assert not bool(flag)
    key = {tuple(np.round(pos[i], 4)): i for i in range(len(sp))}
    sets = {}
    for r in range(len(c_sp)):
        if c_sp[r] < 0:
            continue
        i = key[tuple(np.round(c_pos[r], 4))]
        assert i not in sets, "centre listed twice"
        assert (nbr_sp[r, :cnt[r]] >= 0).all()
        assert (nbr_sp[r, cnt[r]:] == -1).all()
        sets[i] = {key[tuple(np.round(nbr_pos[r, s], 4))]
                   for s in range(cnt[r])}
    return sets


def _assert_sets_match(got, sure, loose):
    assert got.keys() == sure.keys()
    for i in sure:
        assert sure[i] <= got[i] <= sure[i] | loose[i], i


class TestWindowSizing:
    def test_small_cell_returns_none(self):
        assert pair_engine.auto_window(
            (np.eye(3) * 5.0)[None], 2.0, 100, 256) is None

    def test_bench_like_window(self):
        w = pair_engine.auto_window(
            (np.eye(3) * 54.87)[None], 2.0, 10240, 256)
        assert w is not None and w % 128 == 0
        assert 256 + 2 * w < 10240

    def test_no_cutoff_returns_none(self):
        assert pair_engine.auto_window(
            (np.eye(3) * 54.87)[None], 0.0, 10240, 256) is None

    def test_npt_uses_min_width(self):
        cells = np.stack([np.eye(3) * 50.0, np.eye(3) * 40.0])
        assert (pair_engine.auto_window(cells, 2.0, 8000, 256)
                == pair_engine.auto_window(cells[1:], 2.0, 8000, 256))


class TestWindowCoverage:
    def test_every_real_atom_is_a_center_once(self):
        pos, cell, sp = _case(704, 24.0, 3, seed=1, pad_from=650)
        cm = np.full((3, 3), 2.2, np.float32)
        got = _window_sets(pos, cell, sp, cm, window=192)
        assert sorted(got) == np.nonzero(sp >= 0)[0].tolist()

    def test_pad_runs_do_not_break_sets(self):
        """Contiguous pad runs inside the atom axis get spread sort
        keys; the window still covers every real neighbor."""
        rng = np.random.default_rng(11)
        n, box = 1024, 26.0
        cell = (np.eye(3) * box).astype(np.float32)
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        sp = rng.integers(0, 3, n).astype(np.int32)
        for run in (slice(200, 330), slice(600, 730)):
            sp[run] = -1
            pos[run] = 0.0
        cm = np.full((3, 3), 2.0, np.float32)
        window = pair_engine.auto_window(cell[None], 2.0, n, 64)
        got = _window_sets(pos, cell, sp, cm, window=window)
        _assert_sets_match(got, *_oracle_sets(pos, cell, sp, cm))

    def test_thin_slab_window_miss_flagged(self):
        """All atoms in one thin x-slab: the window cannot cover the
        reach and the coverage check raises the flag."""
        pos, cell, sp = _case(704, 24.0, 2, seed=2)
        pos[:, 0] = 1.0 + 0.01 * (pos[:, 0] / 24.0)
        cm = np.full((2, 2), 2.2, np.float32)
        out = _table(pos, cell, sp, cm, max_neighbors=16, chunk=64,
                     window=64)
        assert bool(out[3])


class TestWindowExactness:
    @pytest.mark.parametrize("seed,pad_from,triclinic", [
        (0, None, False),
        (1, 640, False),
        (2, None, True),
    ])
    def test_neighbor_sets_match_brute_force(self, seed, pad_from,
                                             triclinic):
        n, box, s = 704, 23.0, 3
        pos, cell, sp = _case(n, box, s, seed, pad_from=pad_from,
                              triclinic=triclinic)
        cm = _cutoffs(s, seed)
        got = _window_sets(pos, cell, sp, cm, window=192)
        _assert_sets_match(got, *_oracle_sets(pos, cell, sp, cm))

    def test_bad_histograms_match_oracle(self):
        """frame_bad_counts through the window table (with its CN) ==
        the float64 angle and count references."""
        n, box, s = 704, 23.0, 2
        pos, cell, sp = _case(n, box, s, seed=5, pad_from=672)
        cm = np.array([[1.8, 2.0], [2.0, 1.6]], np.float32)
        conc, any_, ovf, cn = bad_kernel.frame_bad_counts(
            pos, cell, sp, cm, s, 1.0, 181, max_neighbors=16, chunk=64,
            window=192, emit_cn=True,
        )
        assert not bool(ovf)
        ref = oracle.bad_counts(pos, cell, sp, cm, s, 1.0, 181)
        assert oracle.cumulative_excess(
            np.asarray(conc)[:, :, 0], ref[0], ref[2], ref[4]) <= 0
        assert oracle.cumulative_excess(
            np.asarray(any_)[:, 0], ref[1], ref[3], ref[5]) <= 0
        cn_ref, cn_near = oracle.cn_counts(pos, cell, sp, cm, s)
        assert (np.abs(np.asarray(cn) - cn_ref) <= cn_near).all()
        assert ref[1].sum() > 0

    def test_overflow_flag(self):
        pos, cell, sp = _case(704, 23.0, 2, seed=7)
        cm = np.full((2, 2), 2.2, np.float32)
        out = _table(pos, cell, sp, cm, max_neighbors=1, chunk=64,
                     window=192)
        assert bool(out[3])  # K=1 must overflow somewhere


class TestRetryLadder:
    def test_make_step_window_matches_full(self):
        """The fused step with the window table equals the full-table
        step on RDF/CN/BAD, and both match the references."""
        from amof_tpu.parallel import pipeline
        from amof_tpu.parallel.mesh import analysis_mesh

        rng = np.random.default_rng(21)
        nf, n, box, s = 2, 704, 23.0, 2
        pos, cell, sp = _case(n, box, s, seed=21, pad_from=672)
        pos = np.stack([pos, ((rng.uniform(0, 1, (n, 3)) @ cell)
                              .astype(np.float32))])
        pos[1, 672:] = 0.0
        cm = np.array([[1.8, 2.0], [2.0, 1.6]], np.float32)
        cells = np.tile(cell, (nf, 1, 1)).astype(np.float32)
        vols = np.full(nf, float(np.linalg.det(cell)), np.float32)
        args = (pos, cells, vols, sp, cm, (sp >= 0).astype(np.float32),
                np.ones(nf, np.float32))
        kw = dict(
            n_species=s, bins=64, dr=0.1, bad_bins=181, dtheta=1.0,
            max_neighbors=16, chunk=64,
            n_atoms_padded=n, with_bad=True, with_msd=False,
            origin_policy="amof",
        )
        mesh = analysis_mesh(1)
        full = pipeline._make_step(mesh, bad_window=None, **kw)(*args)
        win = pipeline._make_step(mesh, bad_window=192, **kw)(*args)
        assert not np.asarray(win["bad_overflow"]).any()
        for key in ("rdf_counts", "cn_counts", "bad_concrete",
                    "bad_center_any"):
            assert np.array_equal(np.asarray(full[key]),
                                  np.asarray(win[key])), key
        conc = sum(oracle.bad_counts(pos[f], cell, sp, cm, s, 1.0, 181)[1]
                   for f in range(nf))
        assert np.array_equal(
            np.asarray(win["bad_center_any"])[:, 0], conc)

    def test_crowded_atom_retries_to_full_capacity(self):
        """A crowded atom overflows the first capacity; the class API's
        ladder (drop the window, then double K) ends on the reference."""
        import amof_tpu.bad as ambad
        from amof_tpu.core.frames import FrameBatch

        rng = np.random.default_rng(3)
        n, box = 2304, 32.0
        pos = rng.uniform(0, box, (1, n, 3)).astype(np.float32)
        z = np.concatenate([np.full(n // 4, 30), np.full(3 * n // 4, 7)])
        # a cluster: 8 Zn among 40 N, ~40 neighbors each (K=16 overflows)
        crowd = np.r_[0:8, n // 4:n // 4 + 40]
        pos[0, crowd] = 16.0 + rng.normal(0, 0.6, (len(crowd), 3))
        batch = FrameBatch(pos, (np.eye(3) * box)[None].astype(np.float32),
                           z.astype(np.int32), np.zeros(1, np.int32))
        bad = ambad.Bad.from_trajectory(batch, {"Zn-N": 2.6}, dtheta=2.0)
        sp = (z == 30).astype(np.int32)  # unique = [7, 30]
        cm = np.array([[0.0, 2.6], [2.6, 0.0]], np.float32)
        ref = oracle.bad_counts(pos[0], (np.eye(3) * box), sp, cm, 2, 2.0,
                                91)
        # "N-Zn-N": centre Zn (1), outer N (0); the class normalizes
        # by the angle total, which the reference fixes
        total = ref[0][1, 0].sum() + ref[4][1, 0]
        assert total > 8 * 16 * 15 / 2
        got = np.rint(bad.data["N-Zn-N"].to_numpy() * total * 2.0)
        assert got.sum() == total
        assert oracle.cumulative_excess(
            got, ref[0][1, 0], ref[2][1, 0], ref[4][1, 0]) <= 0
