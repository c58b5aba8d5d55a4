"""Multichip sharding tests on the 8-virtual-CPU-device mesh: the fused
pipeline must be invariant to the mesh layout."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from amof_tpu.core.frames import Frame
from amof_tpu.parallel.mesh import analysis_mesh
from amof_tpu.parallel.pipeline import FusedAnalysis


def tiny_trajectory(n_frames=8, n_atoms=96, seed=0):
    rng = np.random.default_rng(seed)
    box = 12.0
    species = np.array([30] * 8 + [7] * 24 + [6] * 32 + [1] * 32)[:n_atoms]
    return [
        Frame(rng.uniform(0, box, (n_atoms, 3)), species, np.eye(3) * box)
        for _ in range(n_frames)
    ]


@pytest.fixture(scope="module")
def fused():
    return FusedAnalysis(
        {"Zn-N": 2.5, "C-H": 1.3}, dr=0.05, dtheta=2.0, chunk=16,
        with_bad=True, with_msd=True,
    )


class TestMesh:
    def test_devices_present(self):
        assert len(jax.devices()) == 8

    def test_mesh_shapes(self):
        m = analysis_mesh(8)
        assert m.shape == {"frames": 8, "atoms": 1}
        m2 = analysis_mesh(8, frames_axis=4)
        assert m2.shape == {"frames": 4, "atoms": 2}
        with pytest.raises(ValueError):
            analysis_mesh(8, frames_axis=3)


class TestFusedPipeline:
    @pytest.mark.slow
    def test_mesh_invariance(self, fused):
        frames = tiny_trajectory()
        ref, _ = fused.run(frames, mesh=analysis_mesh(1))
        for fa_ax in [8, 4, 2, 1]:
            mesh = analysis_mesh(8, frames_axis=fa_ax)
            out, _ = fused.run(frames, mesh=mesh)
            for key in ref:
                np.testing.assert_allclose(
                    out[key], ref[key], rtol=1e-4, atol=1e-3,
                    err_msg=f"{key} differs on mesh {dict(mesh.shape)}",
                )

    def test_matches_analysis_classes(self, fused):
        """Fused sharded results == the public single-chip analysis
        classes (RDF counts up to normalization, CN exactly, MSD)."""
        import amof_tpu.cn as amcn
        import amof_tpu.msd as ammsd

        frames = tiny_trajectory()
        out, meta = fused.run(frames, mesh=analysis_mesh(8, frames_axis=4))

        cn = amcn.CoordinationNumber.from_trajectory(
            frames, {"Zn-N": 2.5, "C-H": 1.3}
        )
        unique = list(meta["unique"])
        i_zn, i_n = unique.index(30), unique.index(7)
        n_zn = 8
        np.testing.assert_allclose(
            out["cn_counts"][:, i_zn, i_n] / n_zn,
            cn.data["Zn-N"].to_numpy(), rtol=1e-6,
        )

        msd = ammsd.WindowMsd.from_trajectory(frames, delta_time=1, timestep=1)
        np.testing.assert_allclose(
            out["msd"][: len(msd.data)], msd.data["X"].to_numpy(),
            rtol=2e-3, atol=1e-4,
        )

    def test_chunked_matches_monolithic(self, fused):
        """frames_per_call + atom-blocked MSD == the one-dispatch path
        (VERDICT r2 next #2/#6): pair histograms accumulate exactly in
        f64 across dispatches; MSD runs in atom blocks sharded over
        every device with NO time-axis all_gather, so per-chip peak
        memory is F x A_blk/n_dev x 3 f32 (vs F x A_loc x 3 for the
        monolithic path: at 100k frames x 10k atoms on 8 chips that is
        ~19 MB per block step instead of ~15 GB)."""
        frames = tiny_trajectory(n_frames=16)
        mesh = analysis_mesh(8, frames_axis=4)
        ref, _ = fused.run(frames, mesh=mesh)
        fa = FusedAnalysis(
            {"Zn-N": 2.5, "C-H": 1.3}, dr=0.05, dtheta=2.0, chunk=16,
            with_bad=True, with_msd=True,
            frames_per_call=1, msd_atoms_per_call=16,
        )
        out, meta = fa.run(frames, mesh=mesh)
        assert meta["frames_per_call"] == 4  # 1 * frames_axis
        assert meta["msd_atoms_per_call"] == 16
        for key in ref:
            # final-lag MSD values are FFT-roundoff-scale (~1e-4 on
            # this workload); same atol as the mesh-invariance test
            np.testing.assert_allclose(
                out[key], ref[key], rtol=1e-4, atol=1e-3, err_msg=key
            )

    def test_chunked_capacity_escalation(self):
        """A too-small neighbor capacity escalates per dispatch group
        (never globally): starting from max_neighbors=2 the chunked
        path must still return the exact full-capacity histograms."""
        frames = tiny_trajectory(n_frames=8)
        mesh = analysis_mesh(8, frames_axis=4)
        ref = FusedAnalysis(
            {"Zn-N": 2.5, "C-H": 1.3}, dr=0.05, dtheta=2.0, chunk=16,
            with_msd=False, max_neighbors=16,
        )
        out_ref, _ = ref.run(frames, mesh=mesh)
        assert not np.asarray(out_ref["bad_overflow"]).any()
        small = FusedAnalysis(
            {"Zn-N": 2.5, "C-H": 1.3}, dr=0.05, dtheta=2.0, chunk=16,
            with_msd=False, max_neighbors=2,
            frames_per_call=1,
        )
        out, _ = small.run(frames, mesh=mesh)
        assert not np.asarray(out["bad_overflow"]).any()
        for key in ("rdf_counts", "bad_concrete", "bad_center_any",
                    "cn_counts"):
            np.testing.assert_allclose(
                out[key], out_ref[key], rtol=1e-6, err_msg=key
            )

    def test_chunked_sparse_overflow_rerun(self):
        """ONE crowded frame in a clean trajectory: the flagged frame
        self-masks its BAD/CN contribution on device and is rerun in a
        small padded block at doubled capacity — the group's clean
        frames never pay the doubled table, and the result equals a
        full-capacity run exactly."""
        from amof_tpu.core.frames import FrameBatch

        rng = np.random.default_rng(11)
        n_f, n_a, box = 16, 64, 24.0
        species = np.array([30] * 16 + [7] * 48, np.int32)
        pos = rng.uniform(0, box, (n_f, n_a, 3)).astype(np.float32)
        # frame 5: 12 N atoms collapse around a Zn -> > 8 neighbors
        pos[5, 16:28] = pos[5, 0] + rng.normal(0, 0.5, (12, 3))
        cells = np.tile(np.eye(3, dtype=np.float32) * box, (n_f, 1, 1))
        batch = FrameBatch(
            pos % box, cells, species, np.arange(n_f, dtype=np.int32)
        )
        mesh = analysis_mesh(8, frames_axis=4)
        kw = dict(dr=0.2, dtheta=2.0, chunk=16,
                  with_msd=False)
        ref = FusedAnalysis({"Zn-N": 2.8}, max_neighbors=32, **kw)
        out_ref, _ = ref.run(batch, mesh=mesh)
        assert not np.asarray(out_ref["bad_overflow"]).any()
        small = FusedAnalysis({"Zn-N": 2.8}, max_neighbors=8,
                              frames_per_call=2, **kw)
        out, _ = small.run(batch, mesh=mesh)
        # the rerun resolved the flag; histograms and the flagged
        # frame's CN row match full capacity bit for bit
        assert not np.asarray(out["bad_overflow"]).any()
        for key in ("rdf_counts", "bad_concrete", "bad_center_any",
                    "cn_counts"):
            np.testing.assert_allclose(
                out[key], out_ref[key], rtol=1e-6, err_msg=key
            )

    @pytest.mark.slow
    def test_chunked_long_trajectory_msd(self):
        """F=4096, A=512: the atom-blocked MSD path at a long-time
        shape equals the monolithic result (SURVEY §5.7 'Done'
        criterion)."""
        rng = np.random.default_rng(3)
        from amof_tpu.core.frames import FrameBatch

        n_f, n_a, box = 4096, 512, 40.0
        species = np.array([30] * 128 + [7] * 384, np.int32)
        pos = rng.uniform(0, box, (1, n_a, 3)) + np.cumsum(
            rng.normal(0, 0.05, (n_f, n_a, 3)), axis=0
        )
        cells = np.tile(np.eye(3, dtype=np.float32) * box, (n_f, 1, 1))
        batch = FrameBatch(
            (pos % box).astype(np.float32), cells, species,
            np.arange(n_f, dtype=np.int32),
        )
        mesh = analysis_mesh(8, frames_axis=4)
        mono = FusedAnalysis(
            {"Zn-N": 2.5}, dr=0.5, with_bad=False, with_msd=True,
            chunk=64,
        )
        ref, _ = mono.run(batch, mesh=mesh)
        chunked = FusedAnalysis(
            {"Zn-N": 2.5}, dr=0.5, with_bad=False, with_msd=True,
            chunk=64, frames_per_call=256,
            msd_atoms_per_call=128,
        )
        out, meta = chunked.run(batch, mesh=mesh)
        assert meta["msd_atoms_per_call"] == 128
        # the last few lags average O(1) origins and are dominated by
        # f32 FFT cancellation, which depends on summation grouping;
        # compare them with a looser relative tolerance
        np.testing.assert_allclose(
            out["msd"][:-64], ref["msd"][:-64], rtol=1e-4, atol=1e-3
        )
        np.testing.assert_allclose(
            out["msd"][-64:], ref["msd"][-64:], rtol=0.1, atol=1e-3
        )
        np.testing.assert_allclose(
            out["msd_species"][:-64], ref["msd_species"][:-64],
            rtol=1e-4, atol=1e-3,
        )
        np.testing.assert_allclose(
            out["msd_species"][-64:], ref["msd_species"][-64:],
            rtol=0.1, atol=1e-3,
        )
        np.testing.assert_allclose(
            out["rdf_counts"], ref["rdf_counts"], rtol=1e-6
        )

    def test_frames_not_divisible_raises(self, fused):
        frames = tiny_trajectory(n_frames=6)
        with pytest.raises(ValueError, match="frames"):
            fused.run(frames, mesh=analysis_mesh(8, frames_axis=4))

    @pytest.mark.parametrize("n_frames", [3, 5, 6])
    def test_any_frame_count_on_default_mesh(self, fused, n_frames):
        """With no explicit mesh, atom sharding auto-engages so any
        frame count runs on any device count (VERDICT r1 next #5)."""
        frames = tiny_trajectory(n_frames=n_frames)
        ref, _ = fused.run(frames, mesh=analysis_mesh(1))
        out, meta = fused.run(frames)  # default: all 8 devices
        expect_frames = {3: 1, 5: 1, 6: 2}[n_frames]
        assert meta["mesh"].shape == {
            "frames": expect_frames, "atoms": 8 // expect_frames,
        }
        for key in ref:
            np.testing.assert_allclose(
                out[key], ref[key], rtol=1e-4, atol=1e-3, err_msg=key
            )


def test_fused_pipeline_npt_cells():
    """Per-frame varying cells (NPT): the fused step must weight RDF by
    per-frame volume and feed each frame's cell to every kernel; result
    must match running the frames through the Rdf class."""
    import jax
    from jax.sharding import Mesh

    import amof_tpu.rdf as amrdf
    from amof_tpu.core.frames import Frame, FrameBatch
    from amof_tpu.parallel.pipeline import FusedAnalysis
    from amof_tpu.rdf import shell_volumes

    rng = np.random.default_rng(3)
    n, f = 256, 4
    species = rng.choice([8, 14], n).astype(np.int32)
    frac = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    scales = np.array([9.5, 10.0, 10.5, 10.0], np.float32)
    pos = np.stack([frac * s for s in scales])
    cells = np.eye(3, dtype=np.float32)[None] * scales[:, None, None]
    batch = FrameBatch(pos, cells, species, np.arange(f, dtype=np.int32))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("frames", "atoms"))
    fa = FusedAnalysis({"Si-O": 2.0}, dr=0.1, dtheta=5.0, chunk=64,
                       with_msd=False, max_neighbors=8)
    out, meta = fa.run(batch, mesh=mesh)

    frames = [Frame(p, species, c) for p, c in zip(pos, cells)]
    rdf = amrdf.Rdf.from_trajectory(frames, dr=0.1)
    counts = np.asarray(out["rdf_counts"], np.float64)
    v_shell = shell_volumes(meta["bins"], 0.1)
    g_xx = counts.sum(axis=(0, 1)) / (f * n * n * v_shell)
    assert np.allclose(g_xx, rdf.data["X-X"][:meta["bins"]], rtol=1e-5)


class TestHostParallelMap:
    """The reference's joblib frame fan-out equivalents for host-side
    analyses (VERDICT r1 next #3)."""

    def test_resolve_semantics(self):
        from amof_tpu.parallel.host import resolve_n_workers

        assert resolve_n_workers(False, 100) == 1
        assert resolve_n_workers(None, 100) == 1
        assert resolve_n_workers(True, 100) >= 2
        assert resolve_n_workers(4, 100) == 4
        assert resolve_n_workers(4, 2) == 2  # capped at items

    def test_order_preserved_threads(self):
        from amof_tpu.parallel.host import parallel_map

        out = parallel_map(lambda x: x * x, range(17), 4)
        assert out == [x * x for x in range(17)]

    def test_processes_backend(self):
        from amof_tpu.parallel.host import parallel_map

        out = parallel_map(lambda x: x + 1, range(5), 2,
                           prefer="processes")
        assert out == [1, 2, 3, 4, 5]

    def test_exceptions_propagate(self):
        from amof_tpu.parallel.host import parallel_map

        def boom(x):
            raise RuntimeError("frame failure")

        with pytest.raises(RuntimeError, match="frame failure"):
            parallel_map(boom, range(4), 2)

    def test_ring_parallel_equals_serial(self, zif4_frame):
        import amof_tpu.ring as amring

        cutoffs = {"Zn-N": 2.2, "C-N": 1.7, "C-C": 1.7, "C-H": 1.3,
                   "N-H": 1.3}
        frames = [zif4_frame, zif4_frame]
        serial = amring.Ring.from_trajectory(
            frames, cutoffs, max_search_depth=12, parallel=False)
        par = amring.Ring.from_trajectory(
            frames, cutoffs, max_search_depth=12, parallel=2)
        assert serial.data.keys() == par.data.keys()
        if "ring" in serial.data.keys():
            np.testing.assert_allclose(
                par.data["ring"].values, serial.data["ring"].values)
        assert serial.report_search.equals(par.report_search)

    def test_pore_fallback_parallel_equals_serial(self):
        """Non-batchable pore options (here -volpo) take the per-frame
        path; parallel=2 must fan frames over the thread pool and give
        the same DataFrame as serial (parity:
        amof/pore/core.py:52-61)."""
        import amof_tpu.pore as ampore
        from amof_tpu.pore import grid_kernel

        dirs = grid_kernel.fibonacci_sphere(120)
        frames = []
        for s in (15.0, 15.5, 16.0, 16.5):
            pts = s / 2 + 4.0 * dirs
            frames.append(
                Frame(pts, [8] * len(pts), np.eye(3) * s)
            )
        serial = ampore.Pore.from_trajectory(
            frames, resolution=0.45, volpo=True, parallel=False
        )
        par = ampore.Pore.from_trajectory(
            frames, resolution=0.45, volpo=True, parallel=2
        )
        assert "POAV_A^3" in serial.data.columns  # fallback path taken
        assert list(par.data.columns) == list(serial.data.columns)
        for col in serial.data.columns:
            np.testing.assert_allclose(
                par.data[col], serial.data[col], rtol=1e-6,
                err_msg=col,
            )

    def test_reduce_parallel_equals_serial(self, zif4_frame):
        import amof_tpu.coordination.reduce as amreduce

        frames = [zif4_frame, zif4_frame]
        serial = amreduce.reduce_trajectory(frames, "ZIF-4",
                                            parallel=False)
        par = amreduce.reduce_trajectory(frames, "ZIF-4", parallel=2)
        assert len(par.trajectory) == len(serial.trajectory) == 2
        assert par.report_search["number_of_nodes"].tolist() == \
            serial.report_search["number_of_nodes"].tolist()
        np.testing.assert_allclose(
            par.trajectory[0].get_positions(),
            serial.trajectory[0].get_positions(),
        )
