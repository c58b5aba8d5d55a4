"""analyze(): the fused pipeline must reproduce the individual
reference-parity classes on the same trajectory."""

import numpy as np
import pytest

import amof_tpu.bad as ambad
import amof_tpu.cn as amcn
import amof_tpu.msd as ammsd
import amof_tpu.rdf as amrdf
from amof_tpu.core.frames import Frame
from amof_tpu.pipelines import analyze


@pytest.fixture(scope="module")
def traj():
    rng = np.random.default_rng(4)
    numbers = np.array([30] * 8 + [7] * 24 + [6] * 32)
    box = 12.0
    base = rng.uniform(0, box, (64, 3))
    frames = []
    for t in range(8):
        frames.append(
            Frame(base + rng.normal(0, 0.05, (64, 3)), numbers,
                  np.eye(3) * box)
        )
    return frames


class TestAnalyze:
    def test_matches_individual_classes(self, traj):
        spec = {"Zn-N": 2.5, "C-N": 1.7}
        out = analyze(
            traj, spec, dr=0.05, dtheta=2.0, delta_time=1, timestep=1,
            chunk=16,
        )

        rdf = amrdf.Rdf.from_trajectory(traj, dr=0.05)
        assert list(out["rdf"].data.columns) == list(rdf.data.columns)
        for col in rdf.data.columns:
            np.testing.assert_allclose(
                out["rdf"].data[col], rdf.data[col], rtol=2e-4, atol=1e-6,
                err_msg=col,
            )

        cn = amcn.CoordinationNumber.from_trajectory(traj, spec)
        np.testing.assert_allclose(
            out["cn"].data["Zn-N"], cn.data["Zn-N"], rtol=1e-6
        )

        bad = ambad.Bad.from_trajectory(traj, spec, dtheta=2.0)
        for col in bad.data.columns:
            np.testing.assert_allclose(
                out["bad"].data[col], bad.data[col], rtol=1e-4, atol=1e-8,
                err_msg=col,
            )

        msd = ammsd.WindowMsd.from_trajectory(traj, delta_time=1, timestep=1)
        assert list(out["msd"].data.columns) == list(msd.data.columns)
        for col in msd.data.columns:
            np.testing.assert_allclose(
                out["msd"].data[col], msd.data[col], rtol=5e-3, atol=1e-5,
                err_msg=col,
            )

    def test_objects_roundtrip(self, traj, tmp_path):
        out = analyze(
            traj, {"Zn-N": 2.5}, dr=0.1, dtheta=5.0, delta_time=2,
            timestep=1, chunk=16,
        )
        out["rdf"].write_to_file(tmp_path / "t")
        assert np.allclose(
            amrdf.Rdf.from_file(tmp_path / "t").data, out["rdf"].data
        )
        out["msd"].write_to_file(tmp_path / "t")
        out["cn"].write_to_file(tmp_path / "t")
        out["bad"].write_to_file(tmp_path / "t")
