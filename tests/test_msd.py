"""MSD tests: exact equivalence with a direct implementation of the
reference estimator, free-diffusion oracle, unwrap correctness."""

import numpy as np
import pytest

import amof_tpu.msd as ammsd
from amof_tpu.core.frames import Frame
from amof_tpu.ops import msd_kernel


def reference_window_msd(delta_pos, m):
    """Direct transcription of the reference rolling-sum estimator
    (amof/msd.py:186-205) as the oracle, including its skipped k=0
    origin."""
    msd_partial = np.zeros(len(delta_pos) - m)
    r_k_minus_m = delta_pos[0].copy()
    r_k = np.zeros_like(r_k_minus_m)
    for k in range(0, m + 1):
        r_k += delta_pos[k]
    for k in range(m + 1, len(delta_pos)):
        r_k += delta_pos[k]
        r_k_minus_m += delta_pos[k - m]
        msd_partial[k - m] = np.linalg.norm(r_k - r_k_minus_m) ** 2 / len(r_k)
    return np.mean(msd_partial)


class TestMsdKernel:
    def test_matches_reference_estimator(self):
        """FFT path == reference rolling-sum estimator on a random walk."""
        rng = np.random.default_rng(1)
        T, A = 64, 5
        steps = rng.normal(0, 0.1, (T, A, 3))
        steps[0] = rng.uniform(0, 5, (A, 3))  # initial positions
        x = np.cumsum(steps, axis=0)
        msd_fft = np.asarray(
            msd_kernel.windowed_msd_all_m(x.astype(np.float32), "amof")
        )
        for m in [0, 1, 5, 17, 31]:
            ref = reference_window_msd(list(steps), m)
            # rel 5e-4: f32 FFT accumulation differs slightly across
            # backends (CPU vs GPU)
            assert msd_fft[m] == pytest.approx(ref, rel=5e-4), m

    def test_standard_estimator(self):
        """'standard' includes all origins: check vs brute force."""
        rng = np.random.default_rng(2)
        x = np.cumsum(rng.normal(0, 1, (40, 3, 3)), axis=0)
        msd_fft = np.asarray(
            msd_kernel.windowed_msd_all_m(x.astype(np.float32), "standard")
        )
        for m in [1, 7, 20]:
            brute = np.mean(
                [
                    np.sum((x[k + m] - x[k]) ** 2) / x.shape[1]
                    for k in range(len(x) - m)
                ]
            )
            assert msd_fft[m] == pytest.approx(brute, rel=1e-4)

    def test_unwrap_positions(self):
        """A particle drifting 0.3/frame through a 5 A box must unwrap to
        a straight line."""
        box = 5.0
        true = np.array([[0.1 + 0.3 * t, 2.0, 2.0] for t in range(40)])
        wrapped = true % box
        cells = np.tile(np.eye(3, dtype=np.float32) * box, (40, 1, 1))
        un = np.asarray(
            msd_kernel.unwrap_positions(
                wrapped[:, None, :].astype(np.float32), cells
            )
        )[:, 0]
        assert np.allclose(un, true, atol=1e-5)

    def test_remove_com_drift(self):
        pos = np.random.rand(10, 4, 3).astype(np.float32)
        masses = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
        out = np.asarray(msd_kernel.remove_com_drift(pos, masses))
        com = (out * (masses / masses.sum())[None, :, None]).sum(axis=1)
        assert np.allclose(com, 0, atol=1e-6)


class TestWindowMsd:
    def make_diffusion_traj(self, n_frames=400, n_atoms=32, d_step=0.05,
                            box=20.0, seed=0, wrap=False):
        rng = np.random.default_rng(seed)
        steps = rng.normal(0, d_step, (n_frames, n_atoms, 3))
        steps[0] = rng.uniform(0, box, (n_atoms, 3))
        pos = np.cumsum(steps, axis=0)
        if wrap:
            # wrapping makes the stored COM jump at boundary crossings —
            # the case the reference's unwrap=True flag exists for
            pos = pos % box
        numbers = np.array([18] * (n_atoms // 2) + [36] * (n_atoms // 2))
        return [
            Frame(pos[t], numbers, np.eye(3) * box) for t in range(n_frames)
        ], d_step

    def test_free_diffusion_slope(self):
        frames, d_step = self.make_diffusion_traj()
        msd = ammsd.WindowMsd.from_trajectory(
            frames, delta_time=10, timestep=1, origin_policy="standard"
        )
        d = msd.data
        # MSD(t) = 3 * d_step^2 * t (per-coord variance d_step^2)
        # restrict to small windows: the windowed estimator's variance
        # grows as windows approach half the trajectory (few origins)
        sel = (d["Time"] > 0) & (d["Time"] <= 100)
        t = d["Time"].to_numpy()[sel]
        # COM removal of N atoms rescales diffusion by (1 - 1/N)
        expected = 3 * d_step**2 * t * (1 - 1 / 32)
        assert np.allclose(d["X"].to_numpy()[sel], expected, rtol=0.15)
        assert np.allclose(d["Ar"].to_numpy()[sel], expected, rtol=0.25)

    def test_columns_and_total(self):
        frames, _ = self.make_diffusion_traj(n_frames=50, n_atoms=8)
        msd = ammsd.WindowMsd.from_trajectory(frames, delta_time=5, timestep=1)
        d = msd.data
        assert list(d.columns) == ["Time", "Ar", "Kr", "X"]
        # equal counts -> X is the plain mean
        assert np.allclose(d["X"], (d["Ar"] + d["Kr"]) / 2)
        assert d["X"][0] == 0.0

    def test_window_construction(self):
        frames, _ = self.make_diffusion_traj(n_frames=100, n_atoms=4)
        msd = ammsd.WindowMsd.from_trajectory(
            frames, delta_time=20, max_time="half", timestep=2
        )
        # half time = 100 fs; windows = arange(0, 50, 10) frames
        assert np.array_equal(msd.data["Time"], [0, 20, 40, 60, 80])

    def test_unwrap_flag_equivalence_unwrapped_input(self):
        """For an already-unwrapped trajectory, unwrap True/False agree
        (the extra unwrap pass is a no-op)."""
        frames, _ = self.make_diffusion_traj(n_frames=60, n_atoms=8, seed=3)
        a = ammsd.WindowMsd.from_trajectory(frames, delta_time=6, timestep=1)
        b = ammsd.WindowMsd.from_trajectory(
            frames, delta_time=6, timestep=1, unwrap=True
        )
        assert np.allclose(a.data["X"], b.data["X"], rtol=1e-3, atol=1e-5)

    def test_wrapped_input_needs_unwrap(self):
        """A wrapped trajectory with COM jumps recovers the true MSD with
        unwrap=True (reference docstring scenario, amof/msd.py:169-171)."""
        frames, d_step = self.make_diffusion_traj(
            n_frames=200, n_atoms=16, seed=5, wrap=True
        )
        msd = ammsd.WindowMsd.from_trajectory(
            frames, delta_time=10, timestep=1, unwrap=True,
            origin_policy="standard",
        )
        t = msd.data["Time"].to_numpy()[1:]
        # COM removal of N atoms rescales diffusion by (1 - 1/N)
        expected = 3 * d_step**2 * t * (1 - 1 / 16)
        assert np.allclose(msd.data["X"].to_numpy()[1:], expected, rtol=0.25)

    def test_file_roundtrip(self, tmp_path):
        frames, _ = self.make_diffusion_traj(n_frames=30, n_atoms=4)
        msd = ammsd.WindowMsd.from_trajectory(frames, delta_time=3, timestep=1)
        msd.write_to_file(tmp_path / "t")
        back = ammsd.WindowMsd.from_file(tmp_path / "t")
        assert np.allclose(back.data, msd.data)


class TestDirectMsd:
    def test_static_atoms_zero(self):
        frames = [
            Frame(np.full((3, 3), 1.0), [18, 18, 18], np.eye(3) * 10)
            for _ in range(5)
        ]
        msd = ammsd.DirectMsd.from_trajectory(frames)
        assert np.allclose(msd.data["X"], 0)

    def test_linear_drift(self):
        """One atom moving 0.2/frame: MSD(t) = (0.2 t)^2 (after %-box
        unwrap)."""
        frames = [
            Frame([[1.0 + 0.2 * t, 5.0, 5.0]], [18], np.eye(3) * 10)
            for t in range(10)
        ]
        msd = ammsd.DirectMsd.from_trajectory(frames)
        t = np.arange(10)
        assert np.allclose(msd.data["Ar"], (0.2 * t) ** 2, atol=1e-9)
