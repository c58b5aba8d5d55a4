"""The XLA pore passes against float64 brute force.

* probe-fit voxel masks and MC point fits of ``void_masks_columns``
  against per-voxel / per-point distance tests, including dead pad rows
  of small systems;
* surface-point validity and voxel indices of ``surface_valid_columns``
  against per-point blocker tests, with and without the candidate
  prefilter;
* whole ``BatchedPore`` records (grid -vol) against those references
  plus the flood-fill reference below;
* the flood fill (``label_components``, ``_propagate_fixpoint``,
  ``void_classification_mask``) against ``scipy.ndimage.label`` with
  periodic merging: random masks, a narrow spiral, a straight channel
  through the periodic wrap.

A voxel or point whose float64 distance lies within ``EPS`` of its
threshold may be decided either way by float32 arithmetic (squared
distances of coordinates under 30 Å are off by < 1e-5 Å²), so those are
excluded from the exact comparisons.
"""

import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from amof_tpu.pore import grid_kernel  # noqa: E402

EPS = 2e-5  # Å
IDX_EPS = 1e-4  # voxel units: index ambiguity near a voxel face


# ----------------------------------------------------------------------
# float64 references
# ----------------------------------------------------------------------

def _mic_dist(points_frac, atoms_frac, cell):
    """[P, N] minimum-image distances (float64)."""
    cell = np.asarray(cell, np.float64)
    out = np.empty((len(points_frac), len(atoms_frac)))
    for p0 in range(0, len(points_frac), 2048):
        df = (np.asarray(points_frac[p0:p0 + 2048], np.float64)[:, None]
              - np.asarray(atoms_frac, np.float64)[None])
        df -= np.floor(df + 0.5)
        out[p0:p0 + 2048] = np.linalg.norm(df @ cell, axis=-1)
    return out


def _voxel_centres(grid):
    axes = [(np.arange(g) + 0.5) / g for g in grid]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def _fits(points_frac, frac, cell, radii, t):
    """(fit, ambiguous): the probe of radius t fits at each point."""
    gap = _mic_dist(points_frac, frac, cell) - (np.asarray(radii) + t)
    return gap.min(axis=1) >= 0, (np.abs(gap) < EPS).any(axis=1)


def _masks(frac, cell, radii, grid, t):
    fit, amb = _fits(_voxel_centres(grid), frac, cell, radii, t)
    return fit.reshape(grid), amb.reshape(grid)


def _linear_index(f, grid):
    f = f - np.floor(f)
    fg = f * np.array(grid)
    idx = np.minimum(fg.astype(np.int64), np.array(grid) - 1)
    near = (np.abs(fg - np.rint(fg)) < IDX_EPS).any(axis=-1)
    return (idx[..., 0] * grid[1] + idx[..., 1]) * grid[2] + idx[..., 2], near


def _surface_points(frac, cell, radii, probe, dirs, grid):
    """Per atom and direction: (valid, ambiguous, idx_pt, idx_nudge,
    index_ambiguous), the Zeo++ ASA construction in float64."""
    cell = np.asarray(cell, np.float64)
    inv = np.linalg.inv(cell)
    n, k = len(frac), len(dirs)
    fo = np.asarray(dirs, np.float64) @ inv
    fp = (np.asarray(frac, np.float64)[:, None]
          + (np.asarray(radii, np.float64)[:, None, None] + probe) * fo)
    gap = (_mic_dist(fp.reshape(-1, 3), frac, cell)
           - (np.asarray(radii) + probe)).reshape(n, k, n)
    gap[np.arange(n), :, np.arange(n)] = np.inf  # an atom never blocks itself
    valid = gap.min(axis=2) >= 0
    amb = (np.abs(gap) < EPS).any(axis=2)
    i1, n1 = _linear_index(fp, grid)
    i2, n2 = _linear_index(fp + 0.2 * fo, grid)
    return valid, amb, i1, i2, n1 | n2


def _periodic_labels(mask, periodic):
    """Component label = max linear index of the component (the
    device convention), -1 outside the mask; 6-connectivity."""
    lab, n = scipy.ndimage.label(mask)
    parent = np.arange(n + 1)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    if periodic:
        for axis in range(3):
            a = np.take(lab, -1, axis=axis).ravel()
            b = np.take(lab, 0, axis=axis).ravel()
            for x, y in zip(a[(a > 0) & (b > 0)], b[(a > 0) & (b > 0)]):
                parent[find(x)] = find(y)
    roots = np.array([find(i) for i in range(n + 1)])
    comp = roots[lab]
    lin = np.arange(mask.size).reshape(mask.shape)
    best = np.full(n + 1, -1)
    np.maximum.at(best, comp[mask], lin[mask])
    return np.where(mask, best[comp], -1)


def _classify(mask):
    """(accessible, pocket) by the face test: an open component that
    meets itself across a periodic face seeds a channel, and channels
    spread through periodic connectivity."""
    open_lab = _periodic_labels(mask, periodic=False)
    seeds = np.zeros(mask.shape, bool)
    for axis in range(3):
        a = np.take(open_lab, -1, axis=axis)
        b = np.take(open_lab, 0, axis=axis)
        wins = (a == b) & (a >= 0)
        sl_a = [slice(None)] * 3
        sl_a[axis] = -1
        sl_b = [slice(None)] * 3
        sl_b[axis] = 0
        seeds[tuple(sl_a)] |= wins
        seeds[tuple(sl_b)] |= wins
    per = _periodic_labels(mask, periodic=True)
    chan = np.isin(per, np.unique(per[seeds & mask]))
    accessible = mask & chan
    return accessible, mask & ~accessible


def _init(mask):
    return np.where(
        mask, np.arange(mask.size, dtype=np.int32).reshape(mask.shape), -1
    ).astype(np.int32)


# ----------------------------------------------------------------------
# probe-fit masks, point fits, surface points
# ----------------------------------------------------------------------

def _system(seed, n=700, box=18.0):
    rng = np.random.default_rng(seed)
    frac = rng.random((n, 3)).astype(np.float32)
    frac[:, 2] *= 0.72  # void slab: nonzero surface
    cell = np.eye(3, dtype=np.float32) * box
    radii = rng.uniform(1.2, 1.9, n).astype(np.float32)
    return frac, cell, radii


def _per_atom(valid, gis, idx_pt, idx_nudge, n, k):
    """Map slot-ordered outputs back to per-atom arrays."""
    valid, gis = np.asarray(valid), np.asarray(gis)
    i1, i2 = np.asarray(idx_pt), np.asarray(idx_nudge)
    live = gis >= 0
    assert np.bincount(gis[live], minlength=n).max() <= 1
    v = np.zeros((n, k), bool)
    a1 = np.zeros((n, k), np.int64)
    a2 = np.zeros((n, k), np.int64)
    v[gis[live]] = valid[live]
    a1[gis[live]] = i1[live]
    a2[gis[live]] = i2[live]
    return v, a1, a2, live.sum()


def _surface(frac, cell, radii, grid, dirs, **kw):
    return grid_kernel.surface_valid_columns(
        jnp.asarray(frac), jnp.asarray(cell), jnp.asarray(radii), 1.2,
        jnp.asarray(dirs), grid, **kw,
    )


def _assert_points_match(got, ref, rows=None):
    v, i1, i2, _ = got
    rv, ramb, ri1, ri2, rnear = ref
    rows = np.ones(len(v), bool) if rows is None else rows
    sure = ~ramb & rows[:, None]
    np.testing.assert_array_equal(v[sure], rv[sure])
    idx_ok = sure & ~rnear & rv
    np.testing.assert_array_equal(i1[idx_ok], ri1[idx_ok])
    np.testing.assert_array_equal(i2[idx_ok], ri2[idx_ok])
    assert rv[sure].any()


class TestSurfacePointsOracle:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_all_points_match_oracle(self, seed):
        n, grid = 700, (16, 16, 16)
        frac, cell, radii = _system(seed, n)
        dirs = grid_kernel.fibonacci_sphere(8)
        v, i1, i2, gi, _, missed = _surface(
            frac, cell, radii, grid, dirs, nbx=3, nby=3, window=448,
            chunk=32, col_cap=128)
        assert not bool(missed)
        got = _per_atom(v, gi, i1, i2, n, 8)
        assert got[3] == n  # every atom in exactly one slot
        _assert_points_match(
            got, _surface_points(frac, cell, radii, 1.2, dirs, grid))

    def test_prefilter_classification_match(self):
        n, grid = 700, (16, 16, 16)
        frac, cell, radii = _system(11, n)
        dirs = grid_kernel.fibonacci_sphere(8)
        rng = np.random.default_rng(5)
        acc = rng.random(grid) < 0.10
        poc = (~acc) & (rng.random(grid) < 0.05)
        v, i1, i2, gi, _, missed = _surface(
            frac, cell, radii, grid, dirs, nbx=3, nby=3, window=448,
            chunk=32, col_cap=128, cand_mask=jnp.asarray(acc | poc))
        assert not bool(missed)
        a, na = grid_kernel.classify_surface_points(
            v, i1, i2, jnp.asarray(acc), jnp.asarray(poc))
        rv, ramb, ri1, ri2, rnear = _surface_points(
            frac, cell, radii, 1.2, dirs, grid)
        code = (acc.astype(int) + 2 * poc.astype(int)).ravel()
        c1, c2 = code[ri1], code[ri2]
        r_acc = rv & ((c1 == 1) | (c2 == 1))
        r_nacc = rv & ~((c1 == 1) | (c2 == 1)) & ((c1 == 2) | (c2 == 2))
        loose = int((ramb | rnear).sum())
        got_a = int(np.asarray(a).sum())
        got_n = int(np.asarray(na).sum())
        assert abs(got_a - int(r_acc.sum())) <= loose
        assert abs(got_n - int(r_nacc.sum())) <= loose
        assert r_acc.sum() > 0

    def test_candidate_rows_match_under_prefilter(self):
        n, grid = 700, (16, 16, 16)
        frac, cell, radii = _system(2, n)
        dirs = grid_kernel.fibonacci_sphere(8)
        rng = np.random.default_rng(9)
        cand_mask = jnp.asarray(rng.random(grid) < 0.12)
        cand = np.asarray(grid_kernel.surface_candidate_mask(
            jnp.asarray(frac), jnp.linalg.inv(jnp.asarray(cell)),
            jnp.asarray(radii), 1.2, jnp.asarray(dirs), grid, cand_mask,
        ))
        assert 0 < cand.sum() < n  # mixed population
        v, i1, i2, gi, _, _ = _surface(
            frac, cell, radii, grid, dirs, nbx=3, nby=3, window=448,
            chunk=32, col_cap=128, cand_mask=cand_mask)
        _assert_points_match(
            _per_atom(v, gi, i1, i2, n, 8),
            _surface_points(frac, cell, radii, 1.2, dirs, grid), rows=cand)

    def test_missed_flag_on_overflow(self):
        frac, cell, radii = _system(4)
        *_, missed = _surface(
            frac, cell, radii, (16, 16, 16), grid_kernel.fibonacci_sphere(8),
            nbx=3, nby=3, window=64, chunk=32, col_cap=128)
        assert bool(missed)


class TestVoidMasksOracle:
    @pytest.mark.parametrize("seed,two", [(0, False), (5, True)])
    def test_masks_and_fit_match_oracle(self, seed, two):
        rng = np.random.default_rng(seed)
        n, box, grid = 300, 17.0, (16, 16, 16)
        frac = rng.random((n, 3)).astype(np.float32)
        frac[:, 2] *= 0.7
        cell = np.eye(3, dtype=np.float32) * box
        radii = rng.uniform(1.1, 1.8, n).astype(np.float32)
        probe, chan = (1.0, 1.2) if two else (1.2, 1.2)
        pts = rng.random((3000, 3)).astype(np.float32)
        pts_tiled, w = grid_kernel.assign_points_to_xytiles(
            pts, {"nbx": 4, "nby": 4})
        m_probe, m_chan, fit, missed = grid_kernel.void_masks_columns(
            jnp.asarray(frac), jnp.asarray(cell), jnp.asarray(radii), grid,
            probe=probe, chan=chan, nbx=4, nby=4, window=256,
            pts_tiled=jnp.asarray(pts_tiled))
        assert not bool(missed)
        for got, t in ((m_probe, probe), (m_chan, chan)):
            ref, amb = _masks(frac, cell, radii, grid, t)
            np.testing.assert_array_equal(np.asarray(got)[~amb], ref[~amb])
            assert 0 < ref.sum() < ref.size
        real = np.asarray(w) > 0
        ref, amb = _fits(np.asarray(pts_tiled)[real], frac, cell, radii,
                         probe)
        np.testing.assert_array_equal(np.asarray(fit)[real][~amb],
                                      ref[~amb])

    def test_masks_triclinic_no_points(self):
        rng = np.random.default_rng(3)
        n, grid = 260, (16, 16, 16)
        cell = np.array(
            [[16.0, 0, 0], [1.4, 15.4, 0], [-0.9, 1.1, 15.8]], np.float32)
        frac = rng.random((n, 3)).astype(np.float32)
        frac[:, 2] *= 0.7
        radii = rng.uniform(1.1, 1.8, n).astype(np.float32)
        m_probe, m_chan, fit, missed = grid_kernel.void_masks_columns(
            jnp.asarray(frac), jnp.asarray(cell), jnp.asarray(radii), grid,
            probe=1.2, chan=1.2, nbx=4, nby=4, window=256)
        assert fit is None and not bool(missed)
        ref, amb = _masks(frac, cell, radii, grid, 1.2)
        np.testing.assert_array_equal(np.asarray(m_chan)[~amb], ref[~amb])
        np.testing.assert_array_equal(np.asarray(m_probe)[~amb], ref[~amb])


class TestDeadPadRows:
    def test_small_system_window_overruns_dead_tail(self):
        """N=40 with window=64: every window overruns the real rows
        into the dead pad tail, which must stay inert."""
        rng = np.random.default_rng(1)
        n, box, grid = 40, 20.0, (16, 16, 16)
        frac = rng.random((n, 3)).astype(np.float32)
        cell = np.eye(3, dtype=np.float32) * box
        radii = rng.uniform(1.2, 1.8, n).astype(np.float32)
        pts = rng.random((800, 3)).astype(np.float32)
        pts_tiled, w = grid_kernel.assign_points_to_xytiles(
            pts, {"nbx": 4, "nby": 4})
        m_probe, m_chan, fit, _ = grid_kernel.void_masks_columns(
            jnp.asarray(frac), jnp.asarray(cell), jnp.asarray(radii), grid,
            probe=1.2, chan=1.2, nbx=4, nby=4, window=64,
            pts_tiled=jnp.asarray(pts_tiled))
        ref, amb = _masks(frac, cell, radii, grid, 1.2)
        np.testing.assert_array_equal(np.asarray(m_chan)[~amb], ref[~amb])
        real = np.asarray(w) > 0
        rfit, ramb = _fits(np.asarray(pts_tiled)[real], frac, cell, radii,
                           1.2)
        np.testing.assert_array_equal(np.asarray(fit)[real][~ramb],
                                      rfit[~ramb])
        dirs = grid_kernel.fibonacci_sphere(8)
        v, i1, i2, gi, _, _ = _surface(
            frac, cell, radii, grid, dirs, nbx=3, nby=3, window=24,
            chunk=32, col_cap=32)
        _assert_points_match(
            _per_atom(v, gi, i1, i2, n, 8),
            _surface_points(frac, cell, radii, 1.2, dirs, grid))


class TestBatchedPoreRecords:
    """Whole records (grid -vol) from the float64 masks, the scipy
    flood-fill reference and the float64 surface points."""

    def _check(self, batch, bp):
        from amof_tpu.data import elements
        from amof_tpu.parallel.mesh import analysis_mesh

        recs, meta = bp.run(batch, mesh=analysis_mesh(1))
        assert meta["col_plan"] is not None  # the column path
        grid, k = meta["grid"], meta["k"]
        dirs = grid_kernel.fibonacci_sphere(k)
        radii = elements.vdw_radius_array()[np.asarray(batch.species)]
        for f, rec in enumerate(recs):
            cell = np.asarray(batch.cell[f], np.float64)
            frac = np.asarray(batch.positions[f], np.float64) @ np.linalg.inv(
                cell)
            mask, amb = _masks(frac, cell, radii, grid, bp.probe_radius)
            acc, poc = _classify(mask)
            vox = abs(np.linalg.det(cell)) / mask.size
            slack = amb.sum() * vox
            assert abs(rec["AV_A^3"] - acc.sum() * vox) <= slack + 1e-3
            assert abs(rec["NAV_A^3"] - poc.sum() * vox) <= slack + 1e-3
            rv, ramb, ri1, ri2, rnear = _surface_points(
                frac, cell, radii, bp.probe_radius, dirs, grid)
            code = (acc.astype(int) + 2 * poc.astype(int)).ravel()
            c1, c2 = code[ri1], code[ri2]
            is_acc = (c1 == 1) | (c2 == 1)
            area = 4 * np.pi * (radii + bp.probe_radius) ** 2 / k
            asa = float(np.sum(area[:, None] * (rv & is_acc)))
            loose = float(np.sum(area[:, None] * (ramb | rnear)))
            assert abs(rec["ASA_A^2"] - asa) <= loose + 1e-2 * max(asa, 1)
            assert acc.sum() > 0 and asa > 0

    def test_records_match_oracle(self):
        from amof_tpu.core.frames import FrameBatch
        from amof_tpu.pore.batch import BatchedPore

        rng = np.random.default_rng(23)
        nf, n, box = 1, 2000, 30.0
        pos = rng.uniform(0, box, (nf, n, 3)).astype(np.float32)
        pos[:, :, 2] *= 0.72  # void slab
        batch = FrameBatch(
            pos, np.tile(np.eye(3, dtype=np.float32) * box, (nf, 1, 1)),
            np.full(n, 6, np.int32), np.arange(nf, dtype=np.int32))
        self._check(batch, BatchedPore(resolution=0.6, vol_method="grid"))

    def test_records_triclinic_npt(self):
        """Per-frame varying triclinic cells."""
        from amof_tpu.core.frames import FrameBatch
        from amof_tpu.pore.batch import BatchedPore

        rng = np.random.default_rng(31)
        nf, n = 2, 2000
        base = np.array(
            [[30.0, 0, 0], [2.6, 29.0, 0], [-1.7, 2.1, 29.6]], np.float32)
        cells = np.stack([base * (1.0 + 0.02 * f) for f in range(nf)])
        frac = rng.random((nf, n, 3)).astype(np.float32)
        frac[:, :, 2] *= 0.72
        pos = np.einsum("fni,fij->fnj", frac, cells).astype(np.float32)
        batch = FrameBatch(pos, cells, np.full(n, 6, np.int32),
                           np.arange(nf, dtype=np.int32))
        self._check(batch, BatchedPore(resolution=0.6, vol_method="grid"))


# ----------------------------------------------------------------------
# flood fill
# ----------------------------------------------------------------------

def _random_mask(seed, shape=(16, 12, 20), frac=0.35):
    return np.random.default_rng(seed).random(shape) < frac


class TestFloodFillOracle:
    @pytest.mark.parametrize("periodic", [True, False])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_fixpoint_equivalence(self, periodic, seed):
        mask = _random_mask(seed)
        got = np.asarray(grid_kernel.label_components(
            jnp.asarray(mask), periodic=periodic))
        np.testing.assert_array_equal(got, _periodic_labels(mask, periodic))

    def test_fixpoint_is_stable(self):
        mask = _random_mask(3)
        lab = grid_kernel._propagate_fixpoint(
            jnp.asarray(_init(mask)), True, 8)
        again = grid_kernel._propagate_fixpoint(lab, True, 8)
        np.testing.assert_array_equal(np.asarray(lab), np.asarray(again))

    @pytest.mark.parametrize("periodic", [True, False])
    @pytest.mark.parametrize("sweeps", [1, 2, 4, 8])
    def test_sweeps_per_round(self, periodic, sweeps):
        """Any number of sweeps per convergence check lands on the same
        labels (a round may stop anywhere short of the fixpoint)."""
        for seed in (0, 1):
            mask = _random_mask(seed)
            got = np.asarray(grid_kernel._propagate_fixpoint(
                jnp.asarray(_init(mask)), periodic, sweeps))
            np.testing.assert_array_equal(
                got, _periodic_labels(mask, periodic))

    def test_narrow_spiral(self):
        """A 1-voxel-wide spiral (every run short, constant turns)
        labels as one component; nothing tunnels through walls."""
        g = 12
        mask = np.zeros((4, g, g), bool)
        lo, hi = 0, g - 1
        path = []
        while lo <= hi:
            path += [(lo, zz) for zz in range(lo, hi + 1)]
            path += [(yy, hi) for yy in range(lo + 1, hi + 1)]
            path += [(hi, zz) for zz in range(hi - 1, lo - 1, -1)]
            path += [(yy, lo + 1) for yy in range(hi - 1, lo, -1)]
            lo += 2
            hi -= 2
        for yy, zz in path:
            mask[1, yy, zz] = True
        got = np.asarray(grid_kernel.label_components(
            jnp.asarray(mask), periodic=False))
        np.testing.assert_array_equal(got, _periodic_labels(mask, False))

    @pytest.mark.parametrize("periodic_seed", [0, 1])
    @pytest.mark.parametrize("frac", [0.35, 0.55])
    def test_classification_matches_oracle(self, periodic_seed, frac):
        mask = _random_mask(periodic_seed, frac=frac)
        _, acc, poc = grid_kernel.void_classification_mask(
            jnp.asarray(mask))
        ref_acc, ref_poc = _classify(mask)
        np.testing.assert_array_equal(np.asarray(acc), ref_acc)
        np.testing.assert_array_equal(np.asarray(poc), ref_poc)

    def test_straight_wrap_channel(self):
        """One open straight channel along x through the periodic wrap,
        maximum label at one end: it is one component and accessible."""
        mask = np.zeros((32, 8, 8), bool)
        mask[:, 2, 3] = True
        lab = np.asarray(grid_kernel.label_components(
            jnp.asarray(mask), periodic=True))
        np.testing.assert_array_equal(lab, _periodic_labels(mask, True))
        assert (lab[mask] == lab[mask].max()).all()
        _, acc, poc = grid_kernel.void_classification_mask(
            jnp.asarray(mask))
        assert np.asarray(acc)[mask].all() and not np.asarray(poc).any()
