"""Accumulation precision at north-star frame counts (VERDICT r1 item 6):
the compensated frame scans must match an f64 oracle even where plain
f32 summation provably loses bits (> 2^24 per-bin totals, weighted sums
with ~1e5 dynamic range between addends)."""

import jax.numpy as jnp
import numpy as np
import pytest

from amof_tpu.core.frames import FrameBatch
from amof_tpu.ops import accum, pair_engine
from amof_tpu.parallel.mesh import analysis_mesh
from amof_tpu.parallel.pipeline import FusedAnalysis

N_FRAMES = 1024
N_ATOMS = 320


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    box = 12.0
    species = np.array([30] * 32 + [7] * 64 + [6] * 224, np.int32)
    positions = rng.uniform(0, box, (N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    # NPT-style varying cells so frame weights (volumes) differ
    scale = (1.0 + 0.05 * rng.standard_normal(N_FRAMES)).astype(np.float32)
    cells = np.eye(3, dtype=np.float32)[None] * (box * scale)[:, None, None]
    return FrameBatch(positions, cells, species,
                      np.arange(N_FRAMES, dtype=np.int32))


class TestNeumaierPrimitives:
    def test_beats_plain_f32(self):
        # 1 + 2^24 tiny adds: plain f32 stalls at ~2^24, Neumaier doesn't
        big = jnp.asarray(np.float32(2.0**24))
        carry = accum.neumaier_init(big)
        carry = accum.neumaier_add(carry, big)
        for _ in range(8):
            carry = accum.neumaier_add(carry, jnp.float32(1.0))
        assert float(accum.neumaier_total(carry)) == 2.0**24 + 8
        assert np.float32(2.0**24) + np.float32(1.0) == 2.0**24  # the trap

    def test_scan_sum_matches_f64(self):
        rng = np.random.default_rng(1)
        xs = (rng.uniform(0, 1e6, (4096, 8)).astype(np.float32),)
        got = np.asarray(accum.scan_sum(lambda x: x[0], xs))
        want = xs[0].astype(np.float64).sum(axis=0)
        np.testing.assert_allclose(got, want, rtol=1e-7)
        # plain f32 is measurably worse on the same data
        plain = np.zeros(8, np.float32)
        for row in xs[0]:
            plain = plain + row
        assert np.abs(plain - want).max() > np.abs(got - want).max()


class TestTrajectoryScale:
    @pytest.fixture(scope="class")
    def batch(self):
        return _batch()

    @pytest.fixture(scope="class")
    def per_frame_f64(self, batch):
        """f64 oracle: per-frame counts (integer-exact) summed in f64."""
        import jax

        species_idx = np.array(
            [{6: 0, 7: 1, 30: 2}[z] for z in np.asarray(batch.species)],
            np.int32,
        )
        # one device call for all frames (a python loop of per-frame
        # dispatches dominated this suite's runtime)
        per_frame = jax.jit(lambda ps, cs: jax.lax.map(
            lambda args: pair_engine.frame_rdf_counts(
                args[0], args[1], species_idx, 2.0, 3, 4, chunk=64,
            ),
            (ps, cs),
        ))
        counts = np.asarray(
            per_frame(batch.positions, batch.cell), dtype=np.float64
        )
        assert float(counts.max()) < 2**24  # per-frame counts stay exact
        return species_idx, counts

    def test_unweighted_counts_exact(self, batch, per_frame_f64):
        species_idx, counts = per_frame_f64
        total = np.asarray(pair_engine.trajectory_rdf_counts(
            jnp.asarray(batch.positions), jnp.asarray(batch.cell),
            jnp.asarray(species_idx), 2.0, 3, 4, chunk=64,
        ))
        oracle = counts.sum(axis=0)
        assert oracle.max() > 2**24  # the regime plain f32 cannot hold
        # totals above 2^24 are not representable in one f32 word; the
        # contract is the correctly-rounded sum (<= half-ulp error)
        np.testing.assert_allclose(total, oracle, rtol=2**-24)

    def test_volume_weighted_matches_f64(self, batch, per_frame_f64):
        species_idx, counts = per_frame_f64
        volumes = np.abs(
            np.linalg.det(batch.cell.astype(np.float64))
        )
        total = np.asarray(pair_engine.trajectory_rdf_counts(
            jnp.asarray(batch.positions), jnp.asarray(batch.cell),
            jnp.asarray(species_idx), 2.0, 3, 4, chunk=64,
            frame_weights=jnp.asarray(volumes.astype(np.float32)),
        ))
        oracle = (volumes[:, None, None, None] * counts).sum(axis=0)
        np.testing.assert_allclose(total, oracle, rtol=2e-7)

    @pytest.mark.slow
    def test_fused_pipeline_matches_f64(self, batch, per_frame_f64):
        species_idx, counts = per_frame_f64
        fa = FusedAnalysis(
            {"Zn-N": 2.5, "C-N": 1.7}, dr=2.0, rmax=8.0, dtheta=5.0,
            chunk=64, with_bad=True, with_msd=False,
            max_neighbors=32,
        )
        out, meta = fa.run(batch, mesh=analysis_mesh(8, n_frames=N_FRAMES))
        volumes = np.abs(np.linalg.det(batch.cell.astype(np.float64)))
        oracle = (volumes[:, None, None, None] * counts).sum(axis=0)
        np.testing.assert_allclose(out["rdf_counts"], oracle, rtol=2e-7)
        # BAD bins are unweighted integers: exact after rounding
        assert not out["bad_overflow"].any()
        assert float(out["bad_concrete"].sum()) == pytest.approx(
            round(float(out["bad_concrete"].sum()))
        )
