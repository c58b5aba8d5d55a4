"""Tests for config, profiling, plotting helpers, packaging surface."""

import numpy as np
import pytest

import amof_tpu
from amof_tpu.config import AnalysisConfig
from amof_tpu import profiling


class TestConfig:
    def test_defaults_match_reference(self):
        cfg = AnalysisConfig()
        assert cfg.rdf_dr == 0.01
        assert cfg.rdf_rmax == "half_cell"
        assert cfg.bad_dtheta == 0.05
        assert cfg.msd_delta_time == 100
        assert cfg.ring_max_search_depth == 32
        assert cfg.dist_margin == 1.2
        assert cfg.dist_margin_metal == 1.6
        assert cfg.pore_probe_radius == 1.2

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("AMOF_TPU_RDF_DR", "0.05")
        monkeypatch.setenv("AMOF_TPU_RING_MAX_SEARCH_DEPTH", "16")
        cfg = AnalysisConfig.from_env()
        assert cfg.rdf_dr == 0.05
        assert cfg.ring_max_search_depth == 16


class TestCompileCache:
    def test_env_dir_used_exactly(self, monkeypatch, tmp_path):
        """JAX_COMPILATION_CACHE_DIR is the cache directory as given:
        nothing derived from host, platform or time is appended."""
        import jax

        from amof_tpu import cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        old = jax.config.jax_compilation_cache_dir
        try:
            assert cache.enable_persistent_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", old)

    def test_default_dir_is_fixed_and_ignored(self, monkeypatch):
        import pathlib

        from amof_tpu import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = pathlib.Path(amof_tpu.__file__).resolve().parents[1]
        assert pathlib.Path(cache.cache_dir()) == root / ".jax_cache"
        ignored = (root / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored

    def test_cache_written_only_to_env_dir(self, tmp_path):
        """A process with JAX_COMPILATION_CACHE_DIR set writes compiled
        programs there, and nothing to its HOME or the checkout."""
        import os
        import pathlib
        import subprocess
        import sys

        root = pathlib.Path(amof_tpu.__file__).resolve().parents[1]
        cache_dir, home = tmp_path / "cache", tmp_path / "home"
        home.mkdir()
        default = root / ".jax_cache"
        before = sorted(default.rglob("*")) if default.exists() else None
        code = (
            "import jax, jax.numpy as jnp, amof_tpu\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0)\n"
            "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()"
            "\n"
        )
        env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(home),
                   JAX_COMPILATION_CACHE_DIR=str(cache_dir),
                   PYTHONPATH=str(root))
        subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       check=True, timeout=300)
        assert any(cache_dir.rglob("*"))
        assert not any(home.rglob("*"))
        after = sorted(default.rglob("*")) if default.exists() else None
        assert after == before


class TestProfiling:
    def test_timed_registry(self):
        profiling.reset_timings()
        with profiling.timed("section", sync=False):
            pass
        with profiling.timed("section", sync=False):
            pass
        t = profiling.timings()
        assert t["section"]["count"] == 2
        assert t["section"]["total"] >= 0

    def test_trace_smoke(self, tmp_path):
        import jax.numpy as jnp

        with profiling.trace(tmp_path):
            _ = jnp.ones(8).sum().block_until_ready()
        assert any(tmp_path.rglob("*"))

    def test_stage_device_times_reduction(self):
        """Device events are attributed to the host span they start in;
        busy time is their union, kernel time their sum."""
        from types import SimpleNamespace as NS

        def ev(name, start, dur):
            return NS(name=name, start_ns=start, duration_ns=dur)

        planes = [
            NS(name="/host:CPU", lines=[NS(name="python", events=[
                ev("stage:a", 0, 100), ev("other", 0, 500),
                ev("stage:a", 200, 100), ev("stage:b", 400, 100)])]),
            NS(name="/device:GPU:0", lines=[
                NS(name="Stream #1(Compute)", events=[
                    ev("k1", 10, 40), ev("k2", 30, 40), ev("k3", 210, 10),
                    ev("k4", 150, 10)]),
                NS(name="Stream #2(MemcpyD2H)", events=[ev("c", 420, 20)]),
                NS(name="XLA Ops", events=[ev("op", 10, 400)]),
            ]),
        ]
        times, lines = profiling.stage_device_times(planes)
        assert lines == ["/device:GPU:0|Stream #1(Compute)",
                         "/device:GPU:0|Stream #2(MemcpyD2H)",
                         "/device:GPU:0|XLA Ops"]
        a, b = times["a"], times["b"]
        assert a["window_ns"] == 200 and a["events"] == 3
        assert a["kernel_ns"] == 90 and a["busy_ns"] == 70
        assert a["idle_share"] == pytest.approx(1 - 70 / 200)
        assert b == {"window_ns": 100, "kernel_ns": 20, "busy_ns": 20,
                     "events": 1, "idle_share": pytest.approx(0.8)}

    def test_device_memory_stats(self):
        stats = profiling.device_memory_stats()
        assert len(stats) >= 1


class TestPlot:
    def test_save_plot(self, tmp_path):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from amof_tpu.plot import save_plot

        fig, ax = plt.subplots()
        ax.plot([0, 1], [0, 1])
        out = save_plot(fig, tmp_path / "fig", "png")
        assert out.endswith(".png")
        import pathlib

        assert pathlib.Path(out).stat().st_size > 0

    def test_save_hvplot_gated(self):
        from amof_tpu.plot import save_hvplot

        with pytest.raises((ImportError, ValueError)):
            save_hvplot(object(), "x")


class TestPackageSurface:
    def test_top_level_exports(self):
        assert hasattr(amof_tpu, "Frame")
        assert hasattr(amof_tpu, "FrameBatch")
        assert amof_tpu.__version__

    def test_reference_module_names_resolve(self):
        """A user of the reference finds the same module paths."""
        import amof_tpu.atom
        import amof_tpu.bad
        import amof_tpu.cn
        import amof_tpu.coordination.buildingunits
        import amof_tpu.coordination.core
        import amof_tpu.coordination.reduce
        import amof_tpu.coordination.zif
        import amof_tpu.elastic.core
        import amof_tpu.elastic.elate
        import amof_tpu.files.molsys
        import amof_tpu.files.operation
        import amof_tpu.files.path
        import amof_tpu.io.cp2k
        import amof_tpu.io.lammps
        import amof_tpu.msd
        import amof_tpu.plot
        import amof_tpu.pore.core
        import amof_tpu.rdf
        import amof_tpu.ring.core
        import amof_tpu.structure
        import amof_tpu.symbols
        import amof_tpu.trajectory
