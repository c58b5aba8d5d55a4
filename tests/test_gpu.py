"""The pair engines compiled for the GPU against the float64 references.

Marked ``gpu``: they skip without a card. On a machine with one:
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import numpy as np
import pytest

from amof_tpu import engines, oracle

pytestmark = pytest.mark.gpu


def _glass(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    box = (n / 0.062) ** (1 / 3)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    sp = rng.integers(0, 4, n).astype(np.int32)
    return pos, (np.eye(3) * box).astype(np.float32), sp


def test_gpu_engine_table(gpu_device):
    assert gpu_device.platform == "gpu"
    assert engines.for_backend("gpu") == engines.for_backend()


def test_gpu_rdf_matches_oracle(gpu_device):
    import jax

    from amof_tpu.ops import pair_engine

    pos, cell, sp = _glass()
    bins = int(cell[0, 0] / 2 // 0.01)
    with jax.default_device(gpu_device):
        got = np.asarray(pair_engine.frame_rdf_counts(
            pos, cell, sp, 0.01, 4, bins))
    ref, near = oracle.rdf_counts(pos, cell, sp, 4, 0.01, bins)
    assert oracle.cumulative_excess(got, ref, near) <= 0


def test_gpu_bad_and_cn_match_oracle(gpu_device):
    import jax
    import jax.numpy as jnp

    from amof_tpu.ops import bad_kernel, pair_engine

    pos, cell, sp = _glass()
    cm = np.full((4, 4), 1.9, np.float32)
    window = pair_engine.auto_window(cell[None], 1.9, len(sp), 256)
    with jax.default_device(gpu_device):
        conc, any_, ovf, cn = bad_kernel.frame_bad_counts(
            *map(jnp.asarray, (pos, cell, sp, cm)), 4, 0.05, 3600,
            max_neighbors=16, chunk=256, window=window, emit_cn=True)
    assert not bool(ovf)
    ref = oracle.bad_counts(pos, cell, sp, cm, 4, 0.05, 3600)
    assert oracle.cumulative_excess(
        np.asarray(any_)[:, 0], ref[1], ref[3], ref[5]) <= 0
    cn_ref, cn_near = oracle.cn_counts(pos, cell, sp, cm, 4)
    assert (np.abs(np.asarray(cn) - cn_ref) <= cn_near).all()
