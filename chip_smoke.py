"""
Smoke run of amof_tpu's main path on one GPU, at the width users run.

    python chip_smoke.py            # one GPU: fused + pore + parity
    python chip_smoke.py --multi    # four GPUs: meshes (4,1), (2,2) vs 1

Workload: the 10240-atom ZIF-glass trajectory of ``bench.py`` (ZIF-4
number density, Zn(C3N2H3)2 stoichiometry, random positions from a
seed) with the reference's default binning (dr = 0.01 Å,
amof/rdf.py:38; dtheta = 0.05°) and the bench cutoffs.

Phases (one process; any failure exits non-zero, nothing is caught):

1. device line: JAX platform, device kind and count, and the card's
   name and power limit from ``nvidia-smi``. No GPU -> exit 2.
2. fused pass: ``FusedAnalysis`` (RDF+BAD+CN+MSD) on 256 frames,
   128 frames per call; compile vs steady time, the step's
   ``memory_analysis()`` and the device's peak bytes.
3. pore pass: ``BatchedPore`` -sa -vol on 32 glass frames
   (resolution 0.25, MC volume, connectivity grid 0.5), and on 8
   frames of the same glass with an open void slab at probe 1.0,
   where accessible surface, volume and channel classification work.
4. parity, 2 frames at full width: RDF, CN and BAD against the float64
   references of ``amof_tpu.oracle``; MSD over the 256 frames against
   the direct float64 MSD; pore records against the same
   ``BatchedPore`` program run by a child process on the host CPU
   (``JAX_PLATFORMS=cpu``; it never opens the card).
5. class API: ``Rdf``, ``CoordinationNumber``, ``Bad`` and
   ``WindowMsd.from_trajectory`` on 16 frames agree with
   ``FusedAnalysis`` on the same frames.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

CUTOFFS = {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3}
N_ATOMS = 10240
DR = 0.01
DTHETA = 0.05
MAX_NEIGHBORS = 8
FUSED_FRAMES = 256
FRAMES_PER_CALL = 128
PORE_FRAMES = 32
SLAB_FRAMES = 8
PARITY_FRAMES = 2
CLASS_FRAMES = 16
MULTI_FRAMES = 16
PORE = dict(resolution=0.25, vol_method="mc", conn_resolution=0.5)
POROUS = dict(PORE, probe_radius=1.0, chan_radius=1.0)
PORE_KEYS = ("ASA_A^2", "NASA_A^2", "AV_A^3", "NAV_A^3")
PORE_RTOL = 1e-4
MSD_RTOL = 1e-4


def glass(n_frames):
    """The bench's 10240-atom glass trajectory (seeded)."""
    from bench import make_trajectory

    return make_trajectory(n_frames, N_ATOMS)[0]


def void_slab(n_frames):
    """The glass squeezed into 72% of the cell along z: an open slab
    of ~15 Å that percolates in x and y."""
    batch = glass(n_frames)
    pos = np.array(batch.positions)
    pos[..., 2] *= 0.72
    return batch._replace(positions=pos)


def first(batch, n):
    return batch._replace(positions=batch.positions[:n],
                          cell=batch.cell[:n], step=batch.step[:n])


def fused_analysis():
    from amof_tpu.parallel.pipeline import FusedAnalysis

    return FusedAnalysis(CUTOFFS, dr=DR, dtheta=DTHETA,
                         max_neighbors=MAX_NEIGHBORS,
                         frames_per_call=FRAMES_PER_CALL)


def say(*parts):
    print(*parts, flush=True)


def require_gpu():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        sys.exit(2)
    return devices


def device_line(devices):
    """The device as JAX reports it and, on a GPU, the card's name and
    power limit as nvidia-smi reports them."""
    say(f"device: platform={devices[0].platform} "
        f"kind={devices[0].device_kind} count={len(devices)}")
    if devices[0].platform != "gpu":
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for line in card.splitlines():
        say(f"card: {line}")


def memory_line(name, jitted, *args):
    mem = jitted.lower(*args).compile().memory_analysis()
    say(f"{name} memory_analysis: "
        f"arguments={mem.argument_size_in_bytes} "
        f"outputs={mem.output_size_in_bytes} "
        f"temp={mem.temp_size_in_bytes} "
        f"code={mem.generated_code_size_in_bytes} bytes")


def timed(fn, repeats):
    """(first-call seconds, [steady seconds], last output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first_s = time.perf_counter() - t0
    steady = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        steady.append(time.perf_counter() - t0)
    return first_s, steady, out


def phase_fused():
    import jax

    batch = glass(FUSED_FRAMES)
    step, args, meta = fused_analysis().prepare(batch)
    args = jax.device_put(args)
    first_s, steady, out = timed(lambda: step(*args), repeats=2)
    say(f"fused: {FUSED_FRAMES} frames x {N_ATOMS} atoms, "
        f"bad_window={meta['bad_window']} "
        f"frames_per_call={meta['frames_per_call']}")
    say(f"fused: first call (compile + run) {first_s:.3f} s; steady "
        f"{[round(t, 4) for t in steady]} s = "
        f"{1e3 * min(steady) / FUSED_FRAMES:.4f} ms/frame")
    fpc = meta["frames_per_call"]
    memory_line("fused step", step.pair_steps[(MAX_NEIGHBORS, True)],
                *(a[:fpc] if i in (0, 1, 2, 6) else a
                  for i, a in enumerate(args)))
    s, bins = len(meta["unique"]), meta["bins"]
    assert out["rdf_counts"].shape == (s, s, bins)
    assert out["cn_counts"].shape == (FUSED_FRAMES, s, s)
    assert out["msd"].shape == (FUSED_FRAMES,)
    assert not out["bad_overflow"].any(), "BAD neighbor capacity"
    for key, value in out.items():
        assert np.isfinite(value).all(), key
    return out, meta


def phase_pore(name, batch, params):
    import jax

    from amof_tpu.pore.batch import BatchedPore

    bp = BatchedPore(**params)
    step, args, meta = bp.prepare(batch)
    args = jax.device_put(args)
    first_s, steady, out = timed(lambda: step(*args), repeats=2)
    n = batch.num_frames
    say(f"pore[{name}]: {n} frames, grid={meta['grid']}, first call "
        f"(compile + run) {first_s:.3f} s; steady "
        f"{[round(t, 4) for t in steady]} s = "
        f"{1e3 * min(steady) / n:.4f} ms/frame")
    memory_line(f"pore[{name}] step", step.step_fn,
                *(a[:meta["frames_per_call"]] for a in args))
    records, _ = bp.records(batch, out, meta)
    for rec in records:
        for key in PORE_KEYS:
            assert np.isfinite(rec[key]) and rec[key] >= 0, (name, key)
    return records


def pore_records_on_cpu():
    """Child-process mode: the pore records of the parity frames on
    the host CPU, as JSON on stdout."""
    from amof_tpu.pore.batch import BatchedPore

    sets = {
        "glass": (first(glass(PARITY_FRAMES), PARITY_FRAMES), PORE),
        "void-slab": (first(void_slab(PARITY_FRAMES), PARITY_FRAMES),
                      POROUS),
    }
    out = {}
    for name, (batch, params) in sets.items():
        records, _ = BatchedPore(**params).run(batch)
        out[name] = [{k: r[k] for k in PORE_KEYS} for r in records]
    print(json.dumps(out))


def check(name, ok, detail, reason):
    say(f"parity {name}: {detail} [tolerance: {reason}] -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_parity(fused_out, fused_meta, pore_gpu):
    from amof_tpu import oracle, species
    from amof_tpu.data import elements

    ok = True
    batch = first(glass(FUSED_FRAMES), PARITY_FRAMES)
    out, meta = fused_analysis().run(batch)
    unique, z_to_idx = species.species_table(np.asarray(batch.species))
    sp = z_to_idx[np.asarray(batch.species)]
    s, bins = len(unique), meta["bins"]
    cm = species.cutoff_matrix(CUTOFFS, unique, z_to_idx)
    bad_bins = int(180 // DTHETA) + 1
    rdf = np.zeros((s, s, bins))
    rdf_near = np.zeros((s, s, bins + 1))
    conc = np.zeros((s, s, bad_bins))
    anyc = np.zeros((s, bad_bins))
    near_c = np.zeros((s, s, bad_bins + 1))
    near_a = np.zeros((s, bad_bins + 1))
    loose_c = np.zeros((s, s))
    loose_a = np.zeros(s)
    cn_excess = []
    for f in range(PARITY_FRAMES):
        pos, cell = batch.positions[f], batch.cell[f]
        c, n = oracle.rdf_counts(pos, cell, sp, s, DR, bins)
        rdf += c
        rdf_near += n
        cn_ref, cn_near = oracle.cn_counts(pos, cell, sp, cm, s)
        cn_excess.append(float(np.max(
            np.abs(out["cn_counts"][f] - cn_ref) - cn_near
        )))
        for acc, part in zip(
            (conc, anyc, near_c, near_a, loose_c, loose_a),
            oracle.bad_counts(pos, cell, sp, cm, s, DTHETA, bad_bins),
        ):
            acc += part
    volume = abs(float(np.linalg.det(np.asarray(batch.cell[0], np.float64))))
    rdf_dev = np.rint(out["rdf_counts"] / volume)
    total_dev, total_ref = rdf_dev.sum(), rdf.sum()
    ok &= check(
        "RDF", oracle.cumulative_excess(rdf_dev, rdf, rdf_near) <= 0
        and abs(total_dev - total_ref) <= rdf_near[..., -1].sum(),
        f"{PARITY_FRAMES} frames, {bins} bins x {s * s} species pairs, "
        f"total pairs device {total_dev:.0f} vs float64 {total_ref:.0f}, "
        f"worst edge excess "
        f"{oracle.cumulative_excess(rdf_dev, rdf, rdf_near):.0f}",
        "at every edge the cumulative counts differ by at most the "
        "number of pairs whose float64 distance is within 1e-5 A of it "
        "(f32 distances under 30 A are off by < 4e-6 A)",
    )
    ok &= check(
        "CN", max(cn_excess) <= 0,
        f"worst per-frame excess {max(cn_excess):.0f} "
        f"(device total {out['cn_counts'].sum():.0f})",
        "counts differ by at most the pairs within 1e-5 A of a cutoff",
    )
    ex_c = oracle.cumulative_excess(
        out["bad_concrete"][:, :, 0], conc, near_c, loose_c
    )
    ex_a = oracle.cumulative_excess(
        out["bad_center_any"][:, 0], anyc, near_a, loose_a
    )
    ok &= check(
        "BAD", ex_c <= 0 and ex_a <= 0,
        f"{bad_bins} bins, angles device {out['bad_center_any'].sum():.0f}"
        f" vs float64 {anyc.sum():.0f}, worst edge excess "
        f"concrete {ex_c:.0f} any {ex_a:.0f}",
        "at every edge the cumulative counts differ by at most the "
        "angles within 1e-3 deg of it (widened by 4e-7/sin(theta) rad "
        "near 0 and 180 deg, where arccos amplifies an f32 cosine), "
        "plus angles with a neighbor within 1e-5 A of its cutoff",
    )

    full = glass(FUSED_FRAMES)
    msd_ref, msd_sp_ref = oracle.windowed_msd(
        full.positions, full.cell, elements.mass_of(np.asarray(full.species)),
        sp, s,
    )
    # lags 1 .. T-2: the reference estimator skips the k=0 origin, so
    # the last lag has no origin and no value to compare
    lags = slice(1, FUSED_FRAMES - 1)
    rel = np.max(np.abs(fused_out["msd"][lags] - msd_ref[lags])
                 / msd_ref[lags])
    rel_sp = np.max(np.abs(fused_out["msd_species"][lags]
                           - msd_sp_ref[lags]) / msd_sp_ref[lags])
    ok &= check(
        "MSD", rel <= MSD_RTOL and rel_sp <= MSD_RTOL,
        f"{FUSED_FRAMES} frames, lags 1..{FUSED_FRAMES - 2}, max relative "
        f"error total {rel:.3e} per-species {rel_sp:.3e}",
        f"rtol {MSD_RTOL}: f32 FFT autocorrelation against direct f64",
    )

    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--pore-on-cpu",
         str(N_ATOMS)],
        capture_output=True, text=True, env=env, check=True,
    )
    cpu = json.loads(child.stdout.strip().splitlines()[-1])
    for name, records in cpu.items():
        worst = max(
            abs(gpu[k] - ref[k]) / max(abs(ref[k]), 1e-12)
            if ref[k] else abs(gpu[k])
            for gpu, ref in zip(pore_gpu[name], records) for k in PORE_KEYS
        )
        ok &= check(
            f"pore[{name}]", worst <= PORE_RTOL,
            f"{PARITY_FRAMES} frames, GPU vs host CPU, worst relative "
            f"difference {worst:.3e}",
            f"rtol {PORE_RTOL}: the same program, f32 reassociation only",
        )
    return ok


def phase_class_api():
    """Rdf, CoordinationNumber, Bad and WindowMsd ``from_trajectory`` on
    16 frames against FusedAnalysis on the same frames."""
    import amof_tpu.bad as ambad
    import amof_tpu.cn as amcn
    import amof_tpu.msd as ammsd
    import amof_tpu.rdf as amrdf
    from amof_tpu.data import elements
    from amof_tpu.ops import bad_kernel

    ok = True
    batch = first(glass(FUSED_FRAMES), CLASS_FRAMES)
    t0 = time.perf_counter()
    out, meta = fused_analysis().run(batch)
    say(f"class API: fused reference on {CLASS_FRAMES} frames "
        f"{time.perf_counter() - t0:.3f} s")
    unique, n_f = meta["unique"], CLASS_FRAMES
    species = np.asarray(batch.species)
    syms = [elements.symbol_of(z) for z in unique]
    n_at = np.array([(species == z).sum() for z in unique], np.float64)
    volume = abs(float(np.linalg.det(np.asarray(batch.cell[0], np.float64))))

    t0 = time.perf_counter()
    rdf = amrdf.Rdf.from_trajectory(batch, dr=DR)
    v_shell = amrdf.shell_volumes(meta["bins"], DR)
    ref = np.rint(out["rdf_counts"] / volume)
    worst = 0.0
    for i, a in enumerate(syms):
        for j, b in enumerate(syms):
            got = np.rint(rdf.data[f"{a}-{b}"].to_numpy() * n_f * n_at[i]
                          * len(species) * v_shell / volume)
            worst = max(worst, float(np.max(np.abs(
                np.cumsum(got) - np.cumsum(ref[i, j])))))
    ok &= check(
        "class Rdf", worst <= 1e-6 * ref.sum(),
        f"{time.perf_counter() - t0:.3f} s, worst cumulative pair-count "
        f"difference {worst:.0f} of {ref.sum():.0f}",
        "1e-6 of the pairs: two compiled programs may round a pair on a "
        "bin edge differently",
    )

    t0 = time.perf_counter()
    cn = amcn.CoordinationNumber.from_trajectory(batch, CUTOFFS)
    worst = 0.0
    for spec in CUTOFFS:
        a, b = (syms.index(x) for x in spec.split("-"))
        worst = max(worst, float(np.max(np.abs(
            cn.data[spec].to_numpy() - out["cn_counts"][:, a, b] / n_at[a]
        ))))
    ok &= check("class CoordinationNumber", worst <= 1e-6,
                f"{time.perf_counter() - t0:.3f} s, worst mean-CN "
                f"difference {worst:.3e}", "1e-6: integer counts")

    t0 = time.perf_counter()
    bad = ambad.Bad.from_trajectory(batch, CUTOFFS, dtheta=DTHETA)
    worst = 0.0
    for name, spec in zip(meta["bad_names"], meta["bad_specs"]):
        counts = bad_kernel.select_spec_counts(
            out["bad_concrete"], out["bad_center_any"], spec
        ).sum(axis=0)
        if counts.sum() == 0:
            continue
        got = np.rint(bad.data[name].to_numpy() * counts.sum() * DTHETA)
        worst = max(worst, float(np.max(np.abs(
            np.cumsum(got) - np.cumsum(counts)))))
    ok &= check("class Bad", worst <= 1e-6 * out["bad_center_any"].sum() + 1,
                f"{time.perf_counter() - t0:.3f} s, worst cumulative "
                f"angle-count difference {worst:.0f}",
                "one angle on an edge, as for Rdf")

    t0 = time.perf_counter()
    msd = ammsd.WindowMsd.from_trajectory(batch, delta_time=1, timestep=1)
    lags = msd.data["Time"].to_numpy().astype(int)[1:]
    rel = max(
        float(np.max(np.abs(msd.data[sym].to_numpy()[1:]
                            - out["msd_species"][lags, k])
                     / out["msd_species"][lags, k]))
        for k, sym in enumerate(syms)
    )
    ok &= check("class WindowMsd", rel <= MSD_RTOL,
                f"{time.perf_counter() - t0:.3f} s, lags 1..{lags[-1]}, "
                f"max relative difference {rel:.3e}",
                f"rtol {MSD_RTOL}: two f32 FFT programs")
    return ok


def run_one_gpu():
    devices = require_gpu()
    device_line(devices)
    t_start = time.perf_counter()
    fused_out, fused_meta = phase_fused()
    pore_gpu = {
        "glass": phase_pore("glass", glass(PORE_FRAMES), PORE),
        "void-slab": phase_pore("void-slab", void_slab(SLAB_FRAMES),
                                POROUS),
    }
    for rec in pore_gpu["void-slab"]:
        assert rec["ASA_A^2"] > 0 and rec["AV_A^3"] > 0, rec
    say(f"pore[void-slab]: ASA {pore_gpu['void-slab'][0]['ASA_A^2']:.2f}"
        f" A^2, AV {pore_gpu['void-slab'][0]['AV_A^3']:.2f} A^3 (> 0)")
    stats = devices[0].memory_stats()
    say(f"peak_bytes_in_use: {stats['peak_bytes_in_use']}")
    ok = phase_parity(fused_out, fused_meta, pore_gpu)
    ok &= phase_class_api()
    say(f"wall: {time.perf_counter() - t_start:.1f} s")
    if not ok:
        sys.exit(1)
    return devices


def phase_meshes():
    """FusedAnalysis on meshes (4,1) and (2,2) and BatchedPore on
    (4,1), each against analysis_mesh(1) in the same process."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from amof_tpu.parallel.mesh import analysis_mesh
    from amof_tpu.parallel.pipeline import FusedAnalysis
    from amof_tpu.pore.batch import BatchedPore

    batch = glass(MULTI_FRAMES)
    # one dispatch per mesh (no frames_per_call): the step all-gathers
    # positions over 'atoms' and, for MSD, over 'frames'
    fa = FusedAnalysis(CUTOFFS, dr=DR, dtheta=DTHETA,
                       max_neighbors=MAX_NEIGHBORS)

    def run_on(mesh):
        step, args, _ = fa.prepare(batch, mesh=mesh)
        specs = (P("frames", "atoms", None), P("frames", None, None),
                 P("frames"), P(), P(), P(), P("frames"))
        placed = tuple(
            jax.device_put(a, NamedSharding(mesh, s))
            for a, s in zip(args, specs)
        )
        shards = placed[0].addressable_shards
        used = {sh.device for sh in shards}
        assert len(used) == mesh.size, (
            f"positions live on {len(used)} of {mesh.size} devices")
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(*placed))
        say(f"multi: mesh={dict(mesh.shape)} positions shards "
            f"{[tuple(sh.data.shape) for sh in shards]} on "
            f"{sorted(d.id for d in used)}; first call "
            f"{time.perf_counter() - t0:.3f} s")
        return {k: np.asarray(v) for k, v in out.items()}

    ok = True
    single = run_on(analysis_mesh(1))
    for shape in ((4, 1), (2, 2)):
        multi = run_on(analysis_mesh(4, frames_axis=shape[0]))
        for key in single:
            ref = single[key].astype(np.float64)
            got = multi[key].astype(np.float64)
            rtol = MSD_RTOL if key.startswith("msd") else 1e-5
            bad = np.abs(got - ref) > rtol * np.abs(ref) + 1e-3
            ok &= check(f"mesh{shape} {key}", not bad.any(),
                        f"{int(bad.sum())} of {bad.size} entries differ",
                        f"rtol {rtol}: psum order only")

    pore_batch = glass(SLAB_FRAMES)
    bp = BatchedPore(**PORE)
    ref, _ = bp.run(pore_batch, mesh=analysis_mesh(1))
    got, _ = bp.run(pore_batch, mesh=analysis_mesh(4, frames_axis=4))
    worst = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-12)
                if r[k] else abs(g[k])
                for g, r in zip(got, ref) for k in PORE_KEYS)
    ok &= check("pore mesh(4, 1)", worst <= PORE_RTOL,
                f"{SLAB_FRAMES} frames, worst relative difference "
                f"{worst:.3e}", f"rtol {PORE_RTOL}")
    return ok


def run_four_gpus():
    devices = require_gpu()
    device_line(devices)
    if len(devices) != 4:
        print(f"chip_smoke --multi: needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    ok = phase_meshes()
    say(f"wall: {time.perf_counter() - t_start:.1f} s")
    if not ok:
        sys.exit(1)
    return devices


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-GPU mesh path")
    # child mode of the pore parity: records of N-atom frames on the CPU
    parser.add_argument("--pore-on-cpu", type=int, metavar="N",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.pore_on_cpu:
        global N_ATOMS
        N_ATOMS = args.pore_on_cpu
        pore_records_on_cpu()
        return
    devices = run_four_gpus() if args.multi else run_one_gpu()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
