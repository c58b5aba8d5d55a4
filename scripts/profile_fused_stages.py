"""Per-stage device time of the fused pipeline, from a profiler trace.

Runs on whatever device JAX finds and names it. Each stage is its own
jitted ``lax.map`` over K frames of the chip_smoke glass (10240 atoms,
dr = 0.01, dtheta = 0.05, the bench cutoffs), compiled first, then
called ``--repeats`` times inside ``stage:<name>`` spans of one trace:

  rdf                       the RDF histogram (scatter-add)
  bad:window                BAD + CN through the sorted-window table
  bad:full                  BAD through the full table + the CN pass
  cn:window, cn:full        CN alone, windowed pass vs tiled full pass
  fused                     the whole FusedAnalysis step on K frames

The bad and cn pairs are the engine choices of ``amof_tpu.engines``.
Prints one line per stage (``profiling.profile_stages``: first call,
median host wall, device busy time and idle share, per frame) and a
last JSON line.

    python scripts/profile_fused_stages.py [--frames 16] [--out DIR]
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
    parser.add_argument("--out", default=None,
                        help="trace directory (default: a temporary one)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke as cs
    from amof_tpu import profiling, species
    from amof_tpu.ops import bad_kernel, pair_engine

    devices = jax.devices()
    cs.device_line(devices)
    cs.N_ATOMS = args.atoms
    k = args.frames
    batch = cs.glass(k)
    unique, z_to_idx = species.species_table(np.asarray(batch.species))
    n_sp = len(unique)
    pos, sp = pair_engine.pad_atoms(
        np.asarray(batch.positions), z_to_idx[np.asarray(batch.species)]
    )
    cells = np.asarray(batch.cell)
    cm = species.cutoff_matrix(cs.CUTOFFS, unique, z_to_idx)
    n_pad, chunk = pos.shape[1], 256
    bins = int(float(np.linalg.norm(cells[0], axis=1).min()) / 2 // cs.DR)
    bad_bins = int(180 // cs.DTHETA) + 1
    window = pair_engine.auto_window(cells, float(cm.max()), n_pad, chunk)
    pos_d, cells_d = jax.device_put((pos, cells))
    sp_d, cm_d = jnp.asarray(sp), jnp.asarray(cm)
    print(f"atoms={args.atoms} padded={n_pad} frames={k} bins={bins} "
          f"bad_bins={bad_bins} window={window}")

    def over_frames(frame_fn):
        @jax.jit
        def run(positions, cells):
            out = jax.lax.map(lambda a: frame_fn(*a), (positions, cells))
            return jax.tree.map(lambda x: jnp.sum(x, axis=0), out)

        return lambda: run(pos_d, cells_d)

    def rdf(p, c):
        return pair_engine.frame_rdf_counts(
            p, c, sp_d, cs.DR, n_sp, bins, chunk=chunk)

    def bad_window(p, c):
        return bad_kernel.frame_bad_counts(
            p, c, sp_d, cm_d, n_sp, cs.DTHETA, bad_bins, cs.MAX_NEIGHBORS,
            chunk, window=window, emit_cn=True)

    def bad_full(p, c):
        bad = bad_kernel.frame_bad_counts(
            p, c, sp_d, cm_d, n_sp, cs.DTHETA, bad_bins, cs.MAX_NEIGHBORS,
            chunk, window=None)
        return bad + (pair_engine.frame_cn_counts(
            p, c, sp_d, cm_d, n_sp, chunk=chunk),)

    fa = cs.fused_analysis()
    fa.frames_per_call = k
    step, fargs, _ = fa.prepare(batch)
    fargs = jax.device_put(fargs)
    stages = [
        ("rdf", over_frames(rdf)),
        ("bad:full", over_frames(bad_full)),
        ("cn:full", over_frames(lambda p, c: pair_engine.frame_cn_counts(
            p, c, sp_d, cm_d, n_sp, chunk=chunk))),
        ("fused", lambda: step(*fargs)),
    ]
    if window is not None:  # the cell is wide enough for a window
        stages[1:1] = [
            ("bad:window", over_frames(bad_window)),
            ("cn:window", over_frames(
                lambda p, c: pair_engine.frame_cn_counts_windowed(
                    p, c, sp_d, cm_d, n_sp, chunk, window))),
        ]
    summary = profiling.profile_stages(
        stages, k, repeats=args.repeats, logdir=args.out)
    print(json.dumps({"device": devices[0].device_kind, "frames": k,
                      "atoms": args.atoms, "stages": summary}))


if __name__ == "__main__":
    main()
