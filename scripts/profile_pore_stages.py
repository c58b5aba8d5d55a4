"""Per-stage device time of the batched pore column path, from a
profiler trace.

Runs on whatever device JAX finds and names it. Workload: K frames of
the chip_smoke glass (10240 atoms; resolution 0.25, MC volume,
connectivity grid 0.5), or with ``--void-slab`` the same glass with an
open slab at probe 1.0, where the flood fill and the classifier work.
Each stage is its own jitted ``lax.map`` over the K frames; later
stages include the earlier ones, so a stage's own cost is a difference:

  masks       void_masks_columns: probe-fit and connectivity masks
  masks+mc    the same pass with the MC -vol points riding along
  flood       masks + void_classification_mask (the flood fill)
  surface     masks+mc + flood + surface sampling + classification
  step        the production BatchedPore step (adds output stacking)

Prints one line per stage and a last JSON line.

    python scripts/profile_pore_stages.py [--void-slab] [--frames 16]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--atoms", type=int, default=10240)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--void-slab", action="store_true")
    parser.add_argument("--out", default=None,
                        help="trace directory (default: a temporary one)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke as cs
    from amof_tpu import profiling
    from amof_tpu.data import elements
    from amof_tpu.ops.pair_engine import matvec3
    from amof_tpu.pore import grid_kernel
    from amof_tpu.pore.batch import BatchedPore

    devices = jax.devices()
    cs.device_line(devices)
    cs.N_ATOMS = args.atoms
    k = args.frames
    name = "void-slab" if args.void_slab else "glass"
    batch = cs.void_slab(k) if args.void_slab else cs.glass(k)
    bp = BatchedPore(**(cs.POROUS if args.void_slab else cs.PORE))
    step, pargs, meta = bp.prepare(batch)
    col, surf = meta["col_plan"], meta["surf_plan"]
    grid = col["grid"]
    print(f"{name}: frames={k} grid={grid} col_plan={col} "
          f"surf_plan={surf}")
    radii = jnp.asarray(elements.vdw_radius_array()[
        np.asarray(batch.species)].astype(np.float32))
    probe, chan = bp.probe_radius, bp.chan_radius
    rng = np.random.default_rng(20240817)
    pts = rng.random((bp.num_samples, 3)).astype(np.float32)
    pts_tiled, w = map(jnp.asarray,
                       grid_kernel.assign_points_to_xytiles(pts, col))
    dirs = jnp.asarray(grid_kernel.fibonacci_sphere(meta["k"]))
    pos_d, cells_d = jax.device_put(
        (np.asarray(batch.positions, np.float32),
         np.asarray(batch.cell, np.float32)))

    def masks(pos, cell, with_points):
        frac = matvec3(pos, jnp.linalg.inv(cell))
        frac = frac - jnp.floor(frac)
        return frac, grid_kernel.void_masks_columns(
            frac, cell, radii, grid, probe=probe, chan=chan,
            nbx=col["nbx"], nby=col["nby"], window=col["window"],
            pts_tiled=pts_tiled if with_points else None,
        )

    def s_masks(pos, cell):
        _, (_, m_chan, _, miss) = masks(pos, cell, False)
        return jnp.sum(m_chan), miss

    def s_masks_mc(pos, cell):
        _, (_, m_chan, fit, miss) = masks(pos, cell, True)
        return jnp.sum(m_chan), jnp.sum(fit), miss

    def s_flood(pos, cell):
        _, (_, m_chan, _, miss) = masks(pos, cell, False)
        _, acc, poc = grid_kernel.void_classification_mask(m_chan)
        return jnp.sum(acc), jnp.sum(poc), miss

    def s_surface(pos, cell):
        frac, (_, m_chan, fit, miss) = masks(pos, cell, True)
        _, acc, poc = grid_kernel.void_classification_mask(m_chan)
        acc_pt = grid_kernel.grid_lookup(acc, pts_tiled, grid)
        av = jnp.sum((fit & acc_pt) * w)
        valid, i_pt, i_nu, _, _, miss_s = grid_kernel.surface_valid_columns(
            frac, cell, radii, probe, dirs, grid, nbx=surf["nbx"],
            nby=surf["nby"], window=surf["window"], chunk=surf["chunk"],
            col_cap=surf["col_cap"], cand_mask=m_chan,
        )
        a, n = grid_kernel.classify_surface_points(
            valid, i_pt, i_nu, acc, poc)
        return jnp.sum(a), jnp.sum(n), av, miss | miss_s

    def over_frames(frame_fn):
        @jax.jit
        def run(positions, cells):
            out = jax.lax.map(lambda a: frame_fn(*a), (positions, cells))
            return jax.tree.map(lambda x: jnp.sum(x, axis=0), out)

        return lambda: run(pos_d, cells_d)

    pargs = jax.device_put(pargs)
    stages = [
        ("masks", over_frames(s_masks)),
        ("masks+mc", over_frames(s_masks_mc)),
        ("flood", over_frames(s_flood)),
        ("surface", over_frames(s_surface)),
        ("step", lambda: step(*pargs)),
    ]
    summary = profiling.profile_stages(
        stages, k, repeats=args.repeats, logdir=args.out)
    print(json.dumps({"device": devices[0].device_kind, "set": name,
                      "frames": k, "atoms": args.atoms,
                      "stages": summary}))


if __name__ == "__main__":
    main()
