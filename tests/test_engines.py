"""The engine table, the pandas-free device engines, the float64
references and the tolerance rules of ``amof_tpu.oracle``, and
chip_smoke.py's phases at tiny sizes on the CPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from amof_tpu import engines, oracle

ROOT = pathlib.Path(__file__).resolve().parents[1]


class TestEngineTable:
    def test_cpu_entry(self):
        assert engines.for_backend("cpu") == engines.Engines(
            bad_table="window", cn_table="window")

    def test_gpu_entry_is_complete(self):
        eng = engines.for_backend("gpu")
        assert eng.bad_table in ("window", "full")
        assert eng.cn_table in ("window", "full")

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError, match="no engine table"):
            engines.for_backend("metal")

    def test_default_is_current_backend(self):
        import jax

        assert engines.for_backend() == engines.for_backend(
            jax.default_backend())

    def test_callers_follow_the_table(self, monkeypatch):
        """FusedAnalysis, Bad and CoordinationNumber take their engines
        from the table, and the alternative engines give the same
        results."""
        import amof_tpu.bad as ambad
        import amof_tpu.cn as amcn
        from amof_tpu.core.frames import FrameBatch
        from amof_tpu.parallel.mesh import analysis_mesh
        from amof_tpu.parallel.pipeline import FusedAnalysis

        rng = np.random.default_rng(2)
        n, box = 2304, 32.0
        z = np.concatenate([np.full(n // 4, 30), np.full(3 * n // 4, 7)])
        batch = FrameBatch(
            rng.uniform(0, box, (2, n, 3)).astype(np.float32),
            np.tile(np.eye(3, dtype=np.float32) * box, (2, 1, 1)),
            z.astype(np.int32), np.arange(2, dtype=np.int32))
        cut = {"Zn-N": 2.4}

        def run_all():
            fa = FusedAnalysis(cut, dr=0.1, dtheta=2.0, with_msd=False)
            out, meta = fa.run(batch, mesh=analysis_mesh(1))
            cn = amcn.CoordinationNumber.from_trajectory(batch, cut)
            bad = ambad.Bad.from_trajectory(batch, cut, dtheta=2.0)
            return out, meta, cn.data, bad.data

        out_a, meta_a, cn_a, bad_a = run_all()
        assert meta_a["bad_window"] is not None
        monkeypatch.setitem(engines._BY_BACKEND, "cpu", engines.Engines(
            bad_table="full", cn_table="full"))
        out_b, meta_b, cn_b, bad_b = run_all()
        assert meta_b["bad_window"] is None
        for key in ("rdf_counts", "cn_counts", "bad_concrete",
                    "bad_center_any"):
            np.testing.assert_array_equal(out_a[key], out_b[key], key)
        assert cn_a.equals(cn_b)
        assert bad_a.equals(bad_b)


class TestPackageImports:
    def test_device_engines_import_without_pandas(self):
        """FusedAnalysis and BatchedPore import and run with pandas and
        pyarrow unimportable (the GPU machine is only sure to have jax,
        numpy and scipy)."""
        code = (
            "import sys\n"
            "sys.modules['pandas'] = None\n"
            "sys.modules['pyarrow'] = None\n"
            "import numpy as np\n"
            "from amof_tpu.core.frames import FrameBatch\n"
            "from amof_tpu.parallel.pipeline import FusedAnalysis\n"
            "from amof_tpu.pore.batch import BatchedPore\n"
            "import amof_tpu.oracle, amof_tpu.pore\n"
            "rng = np.random.default_rng(0)\n"
            "b = FrameBatch(rng.uniform(0, 12, (2, 96, 3)).astype('f4'),\n"
            "    np.tile(np.eye(3, dtype='f4') * 12, (2, 1, 1)),\n"
            "    np.array([30] * 24 + [7] * 72, 'i4'), np.arange(2))\n"
            "out, _ = FusedAnalysis({'Zn-N': 2.5}, dr=0.1, dtheta=2.0,\n"
            "    chunk=32).run(b)\n"
            "recs, _ = BatchedPore(resolution=0.6, num_samples=2000).run(b)\n"
            "assert 'pandas' not in sys.modules or sys.modules['pandas'] is None\n"
            "print('ok', out['rdf_counts'].sum() > 0, len(recs))\n"
        )
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, env=env,
                             timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        assert res.stdout.split()[-3:] == ["ok", "True", "2"]

    def test_pore_class_still_importable(self):
        import amof_tpu.pore
        from amof_tpu.pore.core import Pore

        assert amof_tpu.pore.Pore is Pore
        with pytest.raises(AttributeError):
            amof_tpu.pore.NoSuchThing  # noqa: B018


class TestOracle:
    def test_cumulative_excess_edge_rule(self):
        ref = np.array([3.0, 5.0, 2.0])
        moved = np.array([4.0, 4.0, 2.0])  # one pair crossed edge 1
        near = np.zeros(4)
        assert oracle.cumulative_excess(ref, ref, near) <= 0
        assert oracle.cumulative_excess(moved, ref, near) == 1
        near[1] = 1  # ... which the reference saw within EDGE_EPS
        assert oracle.cumulative_excess(moved, ref, near) <= 0
        assert oracle.cumulative_excess(moved, ref, np.zeros(4), 1.0) <= 0

    def test_rdf_counts_simple_cubic(self, simple_cubic_frame):
        f = simple_cubic_frame
        counts, near = oracle.rdf_counts(
            f.positions, f.cell, np.zeros(len(f.positions), int), 1,
            0.05, 79)
        assert counts[0, 0, 40] == 64 * 6  # first shell at 2.0 Å
        assert counts[0, 0, 56] == 64 * 12  # second at 2.83 Å
        assert near[0, 0, 40] == 64 * 6  # exactly on the edge 40 * 0.05

    def test_bad_counts_simple_cubic(self, simple_cubic_frame):
        f = simple_cubic_frame
        sp = np.zeros(len(f.positions), int)
        conc, any_, near_c, near_a, loose_c, loose_a = oracle.bad_counts(
            f.positions, f.cell, sp, np.full((1, 1), 2.1), 1, 1.0, 181)
        # 6 neighbors: 12 right angles and 3 straight ones per atom
        assert any_[0, 90] == 64 * 12 and any_[0, 180] == 64 * 3
        assert any_.sum() == conc.sum() == 64 * 15
        assert loose_a.sum() == 0

    def test_angle_tolerance_widens_near_0_and_180(self):
        tol = oracle.angle_edge_tolerance(np.array([1e-3, 90.0, 179.99]))
        assert tol[1] == pytest.approx(oracle.ANGLE_EPS_DEG, rel=0.05)
        assert tol[0] > 10 * tol[1] and tol[2] > tol[1]

    def test_windowed_msd_matches_recurrence(self):
        """The direct float64 MSD equals the reference's rolling-sum
        recurrence (WindowMsd.compute_msd_of_m) on an unwrapped walk."""
        from amof_tpu.msd import WindowMsd

        rng = np.random.default_rng(4)
        t, n = 24, 5
        steps = rng.normal(0, 0.2, (t - 1, n, 3))
        pos = np.concatenate([np.zeros((1, n, 3)),
                              np.cumsum(steps, axis=0)]) + 20.0
        cells = np.tile(np.eye(3) * 100.0, (t, 1, 1))
        msd, msd_sp = oracle.windowed_msd(pos, cells, np.ones(n),
                                          np.zeros(n, int), 1)
        com = pos.mean(axis=1, keepdims=True)
        delta = np.diff(pos - com, axis=0, prepend=(pos - com)[:1])
        for m in (1, 5, 12):
            assert msd[m] == pytest.approx(
                WindowMsd.compute_msd_of_m(delta, m), rel=1e-10)
        np.testing.assert_allclose(msd_sp[:, 0], msd)


class TestChipSmoke:
    def _run(self, cwd, *args):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable, "chip_smoke.py", *args], cwd=cwd,
            capture_output=True, text=True, env=env, timeout=300)

    def test_exits_nonzero_without_gpu(self):
        res = self._run(ROOT)
        assert res.returncode == 2
        assert '"ok"' not in res.stdout

    def test_fails_outside_the_repo(self, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        res = self._run(tmp_path)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout

    def test_phases_at_tiny_size(self, monkeypatch):
        """Fused, pore and parity phases end to end on the CPU at 1024
        atoms: every parity check holds, the void slab has ASA, AV > 0."""
        monkeypatch.syspath_prepend(str(ROOT))
        import chip_smoke as cs

        for name, value in (("N_ATOMS", 1024), ("FUSED_FRAMES", 8),
                            ("FRAMES_PER_CALL", 4), ("PORE_FRAMES", 2),
                            ("SLAB_FRAMES", 2)):
            monkeypatch.setattr(cs, name, value)
        fused_out, fused_meta = cs.phase_fused()
        pore = {"glass": cs.phase_pore("glass", cs.glass(2), cs.PORE),
                "void-slab": cs.phase_pore("void-slab", cs.void_slab(2),
                                           cs.POROUS)}
        assert all(r["ASA_A^2"] > 0 and r["AV_A^3"] > 0
                   for r in pore["void-slab"])
        assert cs.phase_parity(fused_out, fused_meta, pore)

    def test_class_api_phase_at_tiny_size(self, monkeypatch):
        monkeypatch.syspath_prepend(str(ROOT))
        import chip_smoke as cs

        monkeypatch.setattr(cs, "N_ATOMS", 2048)
        monkeypatch.setattr(cs, "CLASS_FRAMES", 8)
        assert cs.phase_class_api()

    def test_mesh_phase_on_virtual_devices(self, monkeypatch):
        """The --multi path on 4 of the 8 virtual CPU devices: meshes
        (4, 1) and (2, 2) agree with one device, inputs really sharded."""
        monkeypatch.syspath_prepend(str(ROOT))
        import chip_smoke as cs

        for name, value in (("N_ATOMS", 512), ("MULTI_FRAMES", 4),
                            ("SLAB_FRAMES", 4)):
            monkeypatch.setattr(cs, name, value)
        assert cs.phase_meshes()

    def test_glass_frames_are_prefix_consistent(self, monkeypatch):
        """The parity phase regenerates the first frames of a longer
        trajectory; both draws must agree."""
        monkeypatch.syspath_prepend(str(ROOT))
        import chip_smoke as cs

        monkeypatch.setattr(cs, "N_ATOMS", 512)
        long, short = cs.glass(6), cs.glass(2)
        np.testing.assert_array_equal(long.positions[:2], short.positions)
        np.testing.assert_array_equal(cs.void_slab(6).positions[:2],
                                      cs.void_slab(2).positions)
