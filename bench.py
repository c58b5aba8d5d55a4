"""
Benchmark: full RDF+BAD+CN+MSD+pore analysis throughput (frames/sec).

Workload mirrors the north star (BASELINE.json): a 10k-atom
amorphous-ZIF-composition trajectory analyzed with the fused on-device
pipeline PLUS the batched pore (-sa -vol) analysis — all five analyses
the north star specifies.

Needs a GPU (``--smoke`` runs tiny shapes on any backend). Prints the
device line (as chip_smoke.py does), then ONE JSON line:
{"metric", "value", "unit", "device", ...}. Extra diagnostics go to
stderr.
"""

import argparse
import json
import sys
import time

import numpy as np


def make_trajectory(n_frames, n_atoms, seed=0):
    """Amorphous ZIF-glass-like batch: Zn(C3N2H3)2 stoichiometry at the
    ZIF-4 number density (0.062 atoms/A^3)."""
    rng = np.random.default_rng(seed)
    counts = {
        30: n_atoms // 17,          # Zn
        7: 4 * (n_atoms // 17),     # N
        6: 6 * (n_atoms // 17),     # C
    }
    counts[1] = n_atoms - sum(counts.values())  # H fills the rest
    species = np.concatenate(
        [np.full(c, z, np.int64) for z, c in counts.items()]
    )
    box = (n_atoms / 0.062) ** (1 / 3)
    base = rng.uniform(0, box, (n_atoms, 3)).astype(np.float32)
    # frames = base + small thermal displacements (analysis cost is
    # independent of how physical the structure is)
    disp = rng.normal(0, 0.1, (n_frames, n_atoms, 3)).astype(np.float32)
    positions = (base[None] + np.cumsum(disp, axis=0)) % box
    cells = np.tile(np.eye(3, dtype=np.float32) * box, (n_frames, 1, 1))
    from amof_tpu.core.frames import FrameBatch

    return FrameBatch(
        positions, cells, species.astype(np.int32),
        np.arange(n_frames, dtype=np.int32),
    ), box


def make_porous_supercell(n_frames, target_atoms=10240, seed=1,
                          path="/root/reference/examples/files/ZIF-4.xyz"):
    """Replicated crystalline ZIF-4 supercell near the target atom
    count, with small thermal jitter per frame — a genuinely porous
    workload where accessible surface/volume and channel
    classification do real work (VERDICT r2 next #3; fixture:
    amof/examples/Compute structural properties.py:131). Returns
    (FrameBatch, n_atoms) or None when the fixture is unavailable."""
    import os

    if not os.path.exists(path):
        return None
    from amof_tpu.core.frames import FrameBatch
    from amof_tpu.io.xyz import read_xyz

    frame = read_xyz(path, 0)
    base = frame.get_positions()
    cell = np.asarray(frame.get_cell(), np.float64)
    numbers = frame.get_atomic_numbers()
    n0 = len(numbers)
    reps = 1
    shape = (1, 1, 1)
    for na in range(1, 5):
        for nb in range(1, 5):
            for nc in range(1, 5):
                n = n0 * na * nb * nc
                if n <= target_atoms * 1.05 and n > reps * n0:
                    reps, shape = na * nb * nc, (na, nb, nc)
    na, nb, nc = shape
    shifts = np.array([
        i * cell[0] + j * cell[1] + k * cell[2]
        for i in range(na) for j in range(nb) for k in range(nc)
    ])
    pos = (base[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    species = np.tile(numbers, reps).astype(np.int32)
    supercell = (cell.T * np.array([na, nb, nc])).T.astype(np.float32)
    rng = np.random.default_rng(seed)
    disp = rng.normal(0, 0.05, (n_frames, len(pos), 3)).astype(np.float32)
    positions = (pos[None].astype(np.float32) + disp)
    cells = np.tile(supercell, (n_frames, 1, 1))
    return FrameBatch(
        positions, cells, species, np.arange(n_frames, dtype=np.int32)
    ), len(pos)


def cache_stats():
    """(n_entries, total_MB, dir) of the persistent compile cache."""
    import os

    from amof_tpu import cache

    path = cache.cache_dir()
    if not os.path.isdir(path):
        return 0, 0.0, path
    names = os.listdir(path)
    size = sum(
        os.path.getsize(os.path.join(path, f)) for f in names
    )
    return len(names), size / 2**20, path


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=256)
    parser.add_argument("--atoms", type=int, default=10240)
    parser.add_argument("--dr", type=float, default=0.01,
                        help="RDF bin width; default matches the "
                             "reference's own default (amof/rdf.py:38)")
    parser.add_argument("--dtheta", type=float, default=0.05)
    parser.add_argument("--chunk", type=int, default=256)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--smoke", action="store_true",
                        help="tiny shapes for a fast correctness run")
    parser.add_argument("--no-bad", action="store_true")
    parser.add_argument("--no-msd", action="store_true")
    parser.add_argument("--no-pore", action="store_true")
    parser.add_argument("--pore-resolution", type=float, default=0.25,
                        help="pore voxel grid resolution in Angstrom "
                             "(fine grid; used by --pore-vol-method=grid "
                             "and by window-miss fallbacks)")
    parser.add_argument("--pore-vol-method", type=str, default="mc",
                        choices=["mc", "grid"],
                        help="mc = Zeo++'s own estimator (exact probe "
                             "tests at num_samples MC points, coarse "
                             "connectivity grid); grid = deterministic "
                             "fine-grid integration")
    parser.add_argument("--pore-conn-resolution", type=float, default=0.5,
                        help="connectivity-grid resolution for "
                             "--pore-vol-method=mc; exact for this "
                             "workload (no channel is near-critical at "
                             "probe 1.2 A) - keep = resolution for "
                             "near-percolation systems")
    parser.add_argument("--pore-frames", type=int, default=32,
                        help="time pore on this many frames and scale "
                             "to the full count (0 = all frames); the "
                             "per-frame cost is frame-independent, so "
                             "the scaling is exact up to noise")
    parser.add_argument("--frames-per-call", type=int, default=128,
                        help="chunk the fused pipeline into dispatches "
                             "of this many frames per mesh frames-row "
                             "(the production path); MSD runs "
                             "atom-blocked. 0 = monolithic single "
                             "dispatch")
    parser.add_argument("--max-neighbors", type=int, default=8,
                        help="initial BAD neighbor capacity; doubled "
                             "automatically while the overflow flag fires")
    parser.add_argument("--north-star", type=int, default=10240,
                        help="after the timed sections, run the ACTUAL "
                             "north-star workload end to end: this many "
                             "frames (>= the claimed 10k; a multiple of "
                             "128 reuses the 128-frame dispatch programs) "
                             "x --atoms through all five analyses, "
                             "wall-clocked. 0 disables")
    args = parser.parse_args()

    if args.smoke:
        args.frames, args.atoms, args.dr, args.dtheta = 4, 512, 0.1, 1.0

    import jax

    from amof_tpu.parallel.mesh import analysis_mesh
    from amof_tpu.parallel.pipeline import FusedAnalysis

    from chip_smoke import device_line

    devices = jax.devices()
    if devices[0].platform != "gpu" and not args.smoke:
        print(f"bench: needs a GPU (or --smoke), JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        sys.exit(2)
    device_line(devices)

    print(
        f"bench: devices={jax.devices()} frames={args.frames} "
        f"atoms={args.atoms}", file=sys.stderr,
    )
    batch, box = make_trajectory(args.frames, args.atoms)
    mesh = analysis_mesh(n_frames=args.frames)  # all available devices

    k_cap = args.max_neighbors
    while True:
        fa = FusedAnalysis(
            {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3},
            dr=args.dr, dtheta=args.dtheta, chunk=args.chunk,
            with_bad=not args.no_bad,
            with_msd=not args.no_msd, max_neighbors=k_cap,
            frames_per_call=args.frames_per_call or None,
        )
        step_fn, fargs, meta = fa.prepare(batch, mesh=mesh)
        # keep inputs device-resident: numpy args would re-upload the
        # whole batch on every timed call
        fargs = jax.device_put(fargs)

        def run_once():
            return jax.block_until_ready(step_fn(*fargs))

        # snapshot the persistent cache around the first call so hits
        # (0 new entries) vs misses (new entries written) are visible
        n0, mb0, cache_dir = cache_stats()
        t0 = time.time()
        out = run_once()
        compile_time = time.time() - t0
        n1, mb1, _ = cache_stats()
        print(f"bench: cold start: first_call(K={k_cap})={compile_time:.1f}s "
              f"cache[{cache_dir}]: {n0} entries/{mb0:.0f} MB -> "
              f"{n1}/{mb1:.0f} MB ({n1 - n0} misses written)",
              file=sys.stderr)
        if args.no_bad or not np.asarray(out["bad_overflow"]).any():
            break
        k_cap *= 2  # capacity insufficient: retry, never truncate
        print(f"bench: neighbor capacity overflow, retrying with "
              f"K={k_cap}", file=sys.stderr)
        if k_cap > 1024:
            raise RuntimeError("neighbor capacity runaway")

    times = []
    for _ in range(args.repeats):
        t0 = time.time()
        out = run_once()
        times.append(time.time() - t0)
    best = min(times)
    fused_fps = args.frames / best
    print(
        f"bench: fused times={['%.3f' % t for t in times]} "
        f"({fused_fps:.1f} f/s) "
        f"rdf_total={float(np.asarray(out['rdf_counts']).sum()):.3e}",
        file=sys.stderr,
    )

    per_frame_total = best / args.frames
    fused_per_frame = best / args.frames
    analyses = "RDF+BAD+CN+MSD"
    if not args.no_pore:
        from amof_tpu.pore.batch import BatchedPore

        n_pore = min(args.pore_frames or args.frames, args.frames)
        pore_batch = batch if n_pore == args.frames else batch._replace(
            positions=batch.positions[:n_pore], cell=batch.cell[:n_pore],
            step=batch.step[:n_pore],
        )
        bp = BatchedPore(
            resolution=args.pore_resolution,
            vol_method=args.pore_vol_method,
            conn_resolution=args.pore_conn_resolution,
        )
        pore_fn, pore_args, pore_meta = bp.prepare(pore_batch, mesh=mesh)
        pore_args = jax.device_put(pore_args)

        def pore_once():
            res = jax.block_until_ready(pore_fn(*pore_args))
            assert not np.asarray(res[4]).any(), "pore window miss"
            return [float(np.sum(v)) for v in res[:4]]

        t0 = time.time()
        vals = pore_once()
        print(f"bench: pore first call (compile+run) "
              f"{time.time() - t0:.1f}s grid={pore_meta['grid']} "
              f"windows={pore_meta['dist_window']},"
              f"{pore_meta['surf_window']}", file=sys.stderr)
        pore_times = []
        for _ in range(args.repeats):
            t0 = time.time()
            vals = pore_once()
            pore_times.append(time.time() - t0)
        pore_per_frame = min(pore_times) / n_pore
        print(
            f"bench: pore times={['%.3f' % t for t in pore_times]} "
            f"({1 / pore_per_frame:.1f} f/s over {n_pore} frames) "
            f"asa_total={vals[0]:.4g} av_total={vals[2]:.4g}",
            file=sys.stderr,
        )
        per_frame_total += pore_per_frame
        analyses += "+pore"

    diag = {}
    if not args.no_pore and not args.smoke:
        # porous workload: a crystalline ZIF-4 supercell at a probe
        # small enough (1.0 A < the 2.37/2 A aperture radius) that
        # channels percolate — accessible surface/volume and the
        # channel classification do real work in the timed region.
        # All five analyses are timed on THIS geometry too, so the
        # headline does not depend on the glass having zero accessible
        # volume (VERDICT r3 weak #2).
        n_porous = min(16, n_pore)
        porous = make_porous_supercell(max(n_porous, 64))
        if porous is not None:
            p_batch_full, p_atoms = porous
            p_batch = p_batch_full._replace(
                positions=p_batch_full.positions[:n_porous],
                cell=p_batch_full.cell[:n_porous],
                step=p_batch_full.step[:n_porous],
            )
            from amof_tpu.pore.batch import BatchedPore

            bpp = BatchedPore(
                resolution=args.pore_resolution,
                vol_method=args.pore_vol_method,
                conn_resolution=args.pore_conn_resolution,
                probe_radius=1.0, chan_radius=1.0,
            )
            p_fn, p_args, p_meta = bpp.prepare(
                p_batch, mesh=analysis_mesh(n_frames=n_porous)
            )
            p_args = jax.device_put(p_args)

            def porous_once():
                res = jax.block_until_ready(p_fn(*p_args))
                assert not np.asarray(res[4]).any(), "porous window miss"
                return [float(np.sum(v)) for v in res[:4]]

            t0 = time.time()
            pvals = porous_once()
            print(f"bench: porous first call {time.time() - t0:.1f}s "
                  f"atoms={p_atoms} grid={p_meta['grid']}",
                  file=sys.stderr)
            pt = []
            for _ in range(args.repeats):
                t0 = time.time()
                pvals = porous_once()
                pt.append(time.time() - t0)
            p_per_frame = min(pt) / n_porous
            print(
                f"bench: porous ZIF-4 supercell ({p_atoms} atoms) "
                f"pore {p_per_frame * 1e3:.1f} ms/frame "
                f"(glass: {pore_per_frame * 1e3:.1f}) "
                f"asa_total={pvals[0]:.4g} av_total={pvals[2]:.4g}",
                file=sys.stderr,
            )

            # fused RDF+BAD+CN+MSD on the porous supercell
            pf_frames = len(p_batch_full.step)
            pfa = FusedAnalysis(
                {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3},
                dr=args.dr, dtheta=args.dtheta, chunk=args.chunk,
                with_bad=not args.no_bad,
                with_msd=not args.no_msd, max_neighbors=k_cap,
                frames_per_call=min(
                    args.frames_per_call or pf_frames, pf_frames),
            )
            pf_fn, pf_args, _ = pfa.prepare(
                p_batch_full, mesh=analysis_mesh(n_frames=pf_frames))
            pf_args = jax.device_put(pf_args)

            def porous_fused_once():
                return jax.block_until_ready(pf_fn(*pf_args))

            t0 = time.time()
            pf_out = porous_fused_once()
            print(f"bench: porous fused first call {time.time() - t0:.1f}s",
                  file=sys.stderr)
            if not args.no_bad and np.asarray(pf_out["bad_overflow"]).any():
                raise RuntimeError("porous fused neighbor overflow")
            pft = []
            for _ in range(args.repeats):
                t0 = time.time()
                porous_fused_once()
                pft.append(time.time() - t0)
            pf_per_frame = min(pft) / pf_frames
            porous_fps = 1.0 / (pf_per_frame + p_per_frame)
            print(
                f"bench: porous all-five = 1/({pf_per_frame * 1e3:.1f} fused"
                f" + {p_per_frame * 1e3:.1f} pore ms) = "
                f"{porous_fps:.2f} f/s", file=sys.stderr,
            )
            diag = {
                "porous_frames_per_sec": round(porous_fps, 3),
                "porous_pore_ms_per_frame": round(p_per_frame * 1e3, 2),
                "porous_fused_ms_per_frame": round(pf_per_frame * 1e3, 2),
                "porous_asa_total_A2": round(pvals[0], 1),
                "porous_av_total_A3": round(pvals[2], 1),
            }

    if args.north_star and not args.smoke:
        # The ACTUAL north-star workload, not an extrapolation: >= 10k
        # frames x 10k atoms through all five analyses, wall-clocked
        # with device-resident inputs (input upload is reported
        # separately). 10240 frames = 80 dispatches of the same
        # 128-frame programs the timed section compiled.
        nsf = args.north_star
        print(f"bench: north star: generating {nsf} frames x "
              f"{args.atoms} atoms", file=sys.stderr)
        ns_batch, _ = make_trajectory(nsf, args.atoms)
        ns_mesh = analysis_mesh(n_frames=nsf)
        fa_ns = FusedAnalysis(
            {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3},
            dr=args.dr, dtheta=args.dtheta, chunk=args.chunk,
            with_bad=not args.no_bad,
            with_msd=not args.no_msd, max_neighbors=k_cap,
            frames_per_call=args.frames_per_call or None,
        )
        ns_fn, ns_args, _ = fa_ns.prepare(ns_batch, mesh=ns_mesh)
        t0 = time.time()
        ns_args = jax.block_until_ready(jax.device_put(ns_args))
        upload_s = time.time() - t0
        # one pass: it includes compiling the at-scale MSD/COM block
        # programs (the 128-frame pair programs are already compiled)
        t0 = time.time()
        ns_out = jax.block_until_ready(ns_fn(*ns_args))
        ns_fused_s = time.time() - t0
        if not args.no_bad and np.asarray(ns_out["bad_overflow"]).any():
            raise RuntimeError("north-star neighbor overflow")
        del ns_out, ns_args

        ns_pore_s = 0.0
        if not args.no_pore:
            from amof_tpu.pore.batch import BatchedPore

            bp_ns = BatchedPore(
                resolution=args.pore_resolution,
                vol_method=args.pore_vol_method,
                conn_resolution=args.pore_conn_resolution,
            )
            np_fn, np_args, _ = bp_ns.prepare(ns_batch, mesh=ns_mesh)
            t0 = time.time()
            np_args = jax.block_until_ready(jax.device_put(np_args))
            upload_s += time.time() - t0
            t0 = time.time()
            res = jax.block_until_ready(np_fn(*np_args))
            ns_pore_s = time.time() - t0
            assert not np.asarray(res[4]).any(), "pore window miss"
            del res, np_args
        ns_total = ns_fused_s + ns_pore_s
        print(
            f"bench: north star MEASURED: {nsf} frames {analyses} in "
            f"{ns_total:.1f}s on {len(jax.devices())} device(s) (fused "
            f"{ns_fused_s:.1f}s + pore {ns_pore_s:.1f}s; upload "
            f"{upload_s:.1f}s separate)",
            file=sys.stderr,
        )
        diag.update({
            "north_star_frames": nsf,
            "north_star_wall_s": round(ns_total, 1),
            "north_star_fused_s": round(ns_fused_s, 1),
            "north_star_pore_s": round(ns_pore_s, 1),
            "north_star_upload_s": round(upload_s, 1),
        })

    diag["first_call_s"] = round(compile_time, 1)
    frames_per_sec = 1.0 / per_frame_total
    print(json.dumps({
        "metric": (f"frames/sec {analyses}, {args.atoms}-atom amorphous "
                   f"ZIF, dr={args.dr}"),
        "value": round(frames_per_sec, 3),
        "unit": "frames/sec",
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
        **diag,
    }))


if __name__ == "__main__":
    main()
