"""
Fused multi-chip analysis pipeline — the framework's flagship "model".

One SPMD program computes, over a FrameBatch sharded on a
('frames', 'atoms') mesh:

  * RDF species-pair histograms (volume-weighted, psum over both axes),
  * per-frame CN counts (psum over 'atoms', sharded over 'frames'),
  * BAD angle histograms (optional; same sharding as RDF),
  * windowed MSD via FFT (frames all-gathered along time, atoms sharded).

This is the device replacement of the reference's entire joblib
fan-out (SURVEY.md §2 row 20, §5.8): the frame axis is embarrassingly
parallel, so the only real communication is histogram psum-merging and
the two all_gathers that re-shard between pair-space (frames-local,
atoms-sharded) and time-space (atoms-local, frames-gathered).

Shapes must divide the mesh (frames % frames_axis == 0, padded atoms %
atoms_axis == 0); ``FusedAnalysis.run`` pads atoms automatically, and
with no explicit mesh builds one whose frames axis divides the frame
count (excess devices shard atoms), so any frame count runs anywhere.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from amof_tpu import engines, species as amspecies
from amof_tpu.core.frames import as_frame_batch
from amof_tpu.data import elements
from amof_tpu.ops import accum, bad_kernel, msd_kernel, pair_engine
from amof_tpu.parallel.mesh import analysis_mesh


def _make_step(
    mesh,
    n_species: int,
    bins: int,
    dr: float,
    bad_bins: int,
    dtheta: float,
    max_neighbors: int,
    chunk: int,
    n_atoms_padded: int,
    with_bad: bool,
    with_msd: bool,
    origin_policy: str,
    bad_window: Optional[int],
    with_rdf: bool = True,
):
    frames_ax = mesh.shape["frames"]
    atoms_ax = mesh.shape["atoms"]
    a_local = n_atoms_padded // atoms_ax

    def step(positions, cells, volumes, species_idx, cutoff_matrix,
             masses, weights):
        # positions: [F_loc, A_loc, 3]; cells/volumes/weights: [F_loc, ...]
        # species_idx/cutoff_matrix/masses: replicated
        #
        # ``weights`` scales each frame's RDF contribution (0 = ignore:
        # pad rows of the chunked path's rerun blocks). BAD additionally
        # self-masks on the frame's own overflow flag, so a flagged
        # frame contributes NOTHING to the angle histograms — the
        # chunked path then reruns exactly the flagged frames at doubled
        # capacity and their (complete) histograms add cleanly, instead
        # of escalating a whole frames_per_call group (at doubled
        # table cost) because of one crowded atom.
        if atoms_ax == 1:
            i0 = 0  # static full range -> triangular pair tiling
        else:
            a_idx = jax.lax.axis_index("atoms")
            i0 = a_idx * a_local

        pos_atoms_full = jax.lax.all_gather(
            positions, "atoms", axis=1, tiled=True
        )  # [F_loc, N, 3]

        def per_frame(args):
            pos, cell, vol = args
            if with_rdf:
                rdf = vol * pair_engine.frame_rdf_counts(
                    pos, cell, species_idx, dr, n_species, bins,
                    chunk=chunk, i_start=i0, n_i=a_local,
                )
            else:
                # BAD-only rerun step (chunked path): the first pass's
                # RDF was already complete for flagged frames, so the
                # rerun skips the whole pair-histogram pass
                rdf = jnp.zeros((1,), jnp.float32)
            if with_bad and bad_window is not None:
                # the BAD table's verification pass emits CN for free
                bad_c, bad_a, overflow, cn = bad_kernel.frame_bad_counts(
                    pos, cell, species_idx, cutoff_matrix, n_species,
                    dtheta, bad_bins, max_neighbors, chunk,
                    i_start=i0, n_i=a_local, window=bad_window,
                    emit_cn=True,
                )
            else:
                cn = pair_engine.frame_cn_counts(
                    pos, cell, species_idx, cutoff_matrix, n_species,
                    chunk=chunk, i_start=i0, n_i=a_local,
                )
            if with_bad and bad_window is None:
                bad_c, bad_a, overflow = bad_kernel.frame_bad_counts(
                    pos, cell, species_idx, cutoff_matrix, n_species,
                    dtheta, bad_bins, max_neighbors, chunk,
                    i_start=i0, n_i=a_local, window=bad_window,
                )
            elif not with_bad:
                bad_c = jnp.zeros((1,), jnp.float32)
                bad_a = jnp.zeros((1,), jnp.float32)
                overflow = jnp.zeros((), bool)
            return rdf, cn, bad_c, bad_a, overflow

        # compensated frame accumulation (ops/accum.py): weighted RDF
        # sums and BAD bin counts exceed plain-f32 exactness at 10k
        # frames; Neumaier carries keep them ~2^48-exact at f32 speed
        # and avoid materializing the per-frame histogram stack
        frame0 = (pos_atoms_full[0], cells[0], volumes[0])
        rdf_sh, cn_sh, badc_sh, bada_sh, _ = jax.eval_shape(per_frame, frame0)

        def body(carry, args):
            rdf_c, badc_c, bada_c = carry
            pos_f, cell_f, vol_f, w = args
            rdf, cn, bad_c, bad_a, overflow = per_frame(
                (pos_f, cell_f, vol_f)
            )
            ovf_f = jnp.any(overflow)
            if atoms_ax > 1:
                # the flag must mask consistently across atom shards
                # (each shard only sees overflow of ITS center atoms)
                ovf_f = jax.lax.pmax(ovf_f.astype(jnp.int32), "atoms") > 0
            wb = w * (1.0 - ovf_f.astype(jnp.float32))
            carry = (
                accum.neumaier_add(rdf_c, rdf * w),
                accum.neumaier_add(badc_c, bad_c * wb),
                accum.neumaier_add(bada_c, bad_a * wb),
            )
            return carry, (cn, ovf_f)

        init = (
            accum.neumaier_init(rdf_sh),
            accum.neumaier_init(badc_sh),
            accum.neumaier_init(bada_sh),
        )
        (rdf_c, badc_c, bada_c), (cn, ovf) = jax.lax.scan(
            body, init, (pos_atoms_full, cells, volumes, weights)
        )
        rdf = jax.lax.psum(accum.neumaier_total(rdf_c), ("frames", "atoms"))
        cn = jax.lax.psum(cn, "atoms")  # per-frame, stays frame-sharded
        bad_c = jax.lax.psum(accum.neumaier_total(badc_c), ("frames", "atoms"))
        bad_a = jax.lax.psum(accum.neumaier_total(bada_c), ("frames", "atoms"))
        overflow = jax.lax.pmax(ovf.astype(jnp.int32), "atoms")

        out = {
            "rdf_counts": rdf,
            "cn_counts": cn,
            "bad_concrete": bad_c,
            "bad_center_any": bad_a,
            # PER-FRAME flags (frame-sharded like cn): nonzero => some
            # atom of that frame had > max_neighbors within cutoff (or
            # the sorted window missed) and the BAD histograms silently
            # dropped angles; raise K — the chunked path reruns only
            # the flagged frame blocks at doubled capacity
            "bad_overflow": overflow,
        }

        if with_msd:
            # re-shard to time-complete, atom-sharded
            pos_t = jax.lax.all_gather(
                positions, "frames", axis=0, tiled=True
            )  # [F, A_loc, 3]
            cells_t = jax.lax.all_gather(cells, "frames", axis=0, tiled=True)
            m_local = jax.lax.dynamic_slice(masses, (i0,), (a_local,))
            # reference order (amof/msd.py:235-247): COM removal on the
            # stored positions, THEN min-image displacement decomposition
            w_sum = jax.lax.psum(jnp.sum(m_local), "atoms")
            com = jax.lax.psum(
                jnp.sum(pos_t * m_local[None, :, None], axis=1), "atoms"
            ) / w_sum  # [F, 3]
            x = msd_kernel.unwrap_positions(
                pos_t - com[:, None, :], cells_t
            )
            # padding atoms (mass 0) must not contribute displacement
            x = x * (m_local > 0)[None, :, None]
            s = msd_kernel.windowed_msd_atom_series(x, origin_policy)  # [F, A_loc]
            sp_local = jax.lax.dynamic_slice(species_idx, (i0,), (a_local,))
            oh_sp = (
                sp_local[:, None]
                == jax.lax.broadcasted_iota(jnp.int32, (1, n_species), 1)
            ).astype(jnp.float32)  # [A_loc, S]
            msd_sp_sums = jax.lax.psum(
                jax.lax.dot_general(
                    s, oh_sp,
                    dimension_numbers=(((1,), (0,)), ((), ())),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32,
                ),
                "atoms",
            )  # [F, S]
            n_sp = jax.lax.psum(jnp.sum(oh_sp, axis=0), "atoms")  # [S]
            t = pos_t.shape[0]
            origins = (t - jnp.arange(t)).astype(jnp.float32)
            msd_sp = msd_sp_sums / (n_sp[None, :] * origins[:, None])
            out["msd_species"] = msd_sp.at[0].set(0.0)
            n_eff = jnp.sum(n_sp)
            msd = jnp.sum(msd_sp_sums, axis=1) / (n_eff * origins)
            out["msd"] = msd.at[0].set(0.0)
        return out

    in_specs = (
        P("frames", "atoms", None),  # positions
        P("frames", None, None),  # cells
        P("frames"),  # volumes
        P(),  # species_idx
        P(),  # cutoff_matrix
        P(),  # masses
        P("frames"),  # weights
    )
    out_specs = {
        "rdf_counts": P(),
        "cn_counts": P("frames", None, None),
        "bad_concrete": P(),
        "bad_center_any": P(),
        "bad_overflow": P("frames"),
    }
    if with_msd:
        out_specs["msd"] = P()
        out_specs["msd_species"] = P()

    return jax.jit(
        shard_map(
            step, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    )


def _make_msd_block_steps(mesh, n_species: int, origin_policy: str):
    """Atom-blocked MSD steps for the chunked pipeline (SURVEY §5.7:
    bound per-chip memory when frames x atoms exceeds HBM).

    The atom block is sharded over EVERY mesh device (both axes), so
    the time axis arrives complete on each device with NO all_gather —
    per-chip peak memory is F x A_blk / n_devices x 3 f32, bounded by
    the caller's block size, instead of the monolithic path's
    F x A_loc x 3.

    Returns (com_step, msd_step):
      com_step(pos [F, A_blk, 3], masses [A_blk]) ->
          (sum_i m_i x_i [F, 3], sum_i m_i [])  — partial COM sums.
      msd_step(pos, masses, species [A_blk], cells [F, 3, 3],
               com [F, 3]) -> (msd_sp_sums [F, S], n_sp [S]).
    """
    flat = ("frames", "atoms")

    def com_step(positions, masses):
        s = jax.lax.psum(
            jnp.sum(positions * masses[None, :, None], axis=1), flat
        )
        m = jax.lax.psum(jnp.sum(masses), flat)
        return s, m

    def msd_step(positions, masses, species_blk, cells, com):
        x = msd_kernel.unwrap_positions(
            positions - com[:, None, :], cells
        )
        x = x * (masses > 0)[None, :, None]
        s = msd_kernel.windowed_msd_atom_series(x, origin_policy)
        oh_sp = (
            species_blk[:, None]
            == jax.lax.broadcasted_iota(jnp.int32, (1, n_species), 1)
        ).astype(jnp.float32)
        sums = jax.lax.psum(
            jax.lax.dot_general(
                s, oh_sp,
                dimension_numbers=(((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            ),
            flat,
        )
        n_sp = jax.lax.psum(jnp.sum(oh_sp, axis=0), flat)
        return sums, n_sp

    com_fn = jax.jit(shard_map(
        com_step, mesh=mesh,
        in_specs=(P(None, flat, None), P(flat)),
        out_specs=(P(), P()),
        check_vma=False,
    ))
    msd_fn = jax.jit(shard_map(
        msd_step, mesh=mesh,
        in_specs=(
            P(None, flat, None), P(flat), P(flat), P(), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    ))
    return com_fn, msd_fn


class FusedAnalysis:
    """Configurable fused RDF+CN(+BAD)(+MSD) step over a device mesh.

    ``frames_per_call`` bounds each device dispatch to that many frames
    per mesh frames-row (host loop + exact f64 accumulation across
    calls), so a long trajectory never becomes one multi-minute
    program and a crowded frame reruns alone (same design as
    BatchedPore.frames_per_call). MSD then runs as separate
    atom-blocked dispatches (``msd_atoms_per_call``) with no time-axis
    gather, bounding per-device memory at 100k-frame scale (SURVEY
    §5.7).

    The "auto" ``bad_window`` follows
    ``amof_tpu.engines.for_backend().bad_table``.
    """

    def __init__(
        self,
        nb_set_and_cutoff,
        dr: float = 0.02,
        rmax: Optional[float] = None,
        dtheta: float = 1.0,
        max_neighbors: int = 16,
        with_bad: bool = True,
        with_msd: bool = True,
        chunk: int = 256,
        origin_policy: str = "amof",
        bad_window="auto",
        frames_per_call: Optional[int] = None,
        msd_atoms_per_call: Optional[int] = None,
    ):
        self.nb_set_and_cutoff = nb_set_and_cutoff
        self.dr = dr
        self.rmax = rmax
        self.dtheta = dtheta
        self.max_neighbors = max_neighbors
        self.with_bad = with_bad
        self.with_msd = with_msd
        self.chunk = chunk
        self.origin_policy = origin_policy
        # sorted-window BAD neighbor search: "auto" sizes the window from
        # the density and max cutoff when the backend's engine is the
        # window table; None forces the full O(N^2) table; an int is
        # used as-is. Misses are caught by the overflow flag.
        self.bad_window = bad_window
        self.frames_per_call = frames_per_call
        self.msd_atoms_per_call = msd_atoms_per_call

    def prepare(self, batch, mesh=None):
        """Resolve static shapes; returns (step_fn, args, meta)."""
        batch = as_frame_batch(batch)
        mesh = mesh or analysis_mesh(n_frames=batch.num_frames)
        eng = engines.for_backend()
        species = np.asarray(batch.species)
        unique, z_to_idx = amspecies.species_table(species)
        n_species = len(unique)

        cells = np.asarray(batch.cell)
        lengths = np.linalg.norm(cells.astype(np.float64), axis=2)
        rmax = self.rmax or float(lengths.min()) / 2
        bins = int(rmax // self.dr)

        atoms_ax = mesh.shape["atoms"]
        # every device's atom slice must itself divide into chunks
        positions, species_idx = pair_engine.pad_atoms(
            np.asarray(batch.positions), z_to_idx[species],
            self.chunk * atoms_ax,
        )
        if batch.num_frames % mesh.shape["frames"]:
            raise ValueError(
                f"frame count ({batch.num_frames}) is not divisible by "
                f"the mesh 'frames' axis ({mesh.shape['frames']}); build "
                f"the mesh with analysis_mesh(n_frames="
                f"{batch.num_frames}) to auto-split frames/atoms"
            )

        cutoff_matrix = amspecies.cutoff_matrix(
            self.nb_set_and_cutoff, unique, z_to_idx
        )
        pairs, bad_names = amspecies.bad_specs(self.nb_set_and_cutoff, unique)
        bad_specs = tuple(
            (
                -1 if a == "X" else int(z_to_idx[a]),
                -1 if b == "X" else int(z_to_idx[b]),
            )
            for a, b in pairs
        )
        bad_bins = int(180 // self.dtheta) + 1
        # per-slot masses (pad rows weigh 0)
        z_slot = np.asarray(unique)[np.maximum(species_idx, 0)]
        masses = np.where(
            species_idx >= 0, elements.mass_of(z_slot), 0.0
        ).astype(positions.dtype)
        volumes = np.abs(np.linalg.det(cells.astype(np.float64))).astype(
            positions.dtype
        )

        bad_window = self.bad_window
        if bad_window == "auto":
            bad_window = None
            if eng.bad_table == "window":
                bad_window = pair_engine.auto_window(
                    cells, float(cutoff_matrix.max()), positions.shape[1],
                    self.chunk,
                )
        if bad_window is not None and (
            self.chunk + 2 * bad_window >= positions.shape[1]
        ):
            bad_window = None

        args = (
            positions, np.asarray(batch.cell), volumes,
            species_idx, cutoff_matrix, masses,
            np.ones(batch.num_frames, positions.dtype),
        )
        meta = {
            "unique": unique, "bins": bins, "rmax": rmax,
            "bad_names": bad_names, "bad_specs": bad_specs, "mesh": mesh,
            "bad_window": bad_window,
        }

        if self.frames_per_call is not None:
            step_fn = self._make_chunked_step(
                mesh, n_species, bins, bad_bins, positions, bad_window,
                meta,
            )
            return step_fn, args, meta

        step_fn = _make_step(
            mesh, n_species, bins, float(self.dr), bad_bins,
            float(self.dtheta), self.max_neighbors, self.chunk,
            positions.shape[1], self.with_bad, self.with_msd,
            self.origin_policy, bad_window,
        )
        return step_fn, args, meta

    def _make_chunked_step(self, mesh, n_species, bins, bad_bins,
                           positions, bad_window, meta):
        """Host-looped step: pair stage in <= frames_per_call-frame
        dispatches (f64 accumulation across calls is exact at any
        frame count), MSD in atom-blocked dispatches with bounded
        per-chip memory. Device-resident args are sliced on device —
        no per-chunk re-upload."""
        n_frames, n_pad = positions.shape[0], positions.shape[1]
        f_ax = mesh.shape["frames"]
        n_dev = f_ax * mesh.shape["atoms"]
        target = max(self.frames_per_call, 1) * f_ax
        fpc = f_ax
        for d in range(min(target, n_frames), f_ax - 1, -f_ax):
            if n_frames % d == 0:
                fpc = d
                break
        # pair steps are compiled per neighbor capacity, lazily: a
        # single crowded atom anywhere in a long trajectory must not
        # force the doubled-capacity (2x-cost) BAD tables on ANY clean
        # frame (K=8 suffices for most north-star frames, but one atom
        # in 256 frames overflows it). Flagged frames self-mask their
        # BAD contribution inside the step (see _make_step), so the
        # first pass is already correct-and-complete for every clean
        # frame; only the flagged frames rerun, in power-of-two padded
        # blocks at doubled capacity with the RDF pass skipped. A group
        # where > 1/2 of frames flag escalates wholesale instead and is
        # REMEMBERED across calls (capacity requirements are a property
        # of the data).
        pair_steps = {}
        group_caps = {}

        def get_pair_step(k_cap, with_rdf=True):
            key = (k_cap, with_rdf)
            if key not in pair_steps:
                pair_steps[key] = _make_step(
                    mesh, n_species, bins, float(self.dr), bad_bins,
                    float(self.dtheta), k_cap, self.chunk, n_pad, self.with_bad, False, self.origin_policy,
                    bad_window, with_rdf=with_rdf,
                )
            return pair_steps[key]

        meta["frames_per_call"] = fpc

        if self.with_msd:
            com_fn, msd_fn = _make_msd_block_steps(
                mesh, n_species, self.origin_policy
            )
            # atom block: divides the padded atom count, multiple of
            # the flat device count (the block is sharded over EVERY
            # device). Auto-sizing targets ~256 MB of per-device series
            # (F x A_blk/n_dev x 3 f32 x a few live copies): one block
            # at bench scale, ~50 blocks at 100k frames x 10k atoms.
            a_target = self.msd_atoms_per_call or int(max(
                n_dev, min(n_pad, 256e6 * n_dev // (12 * n_frames))
            ))
            a_blk = n_dev
            for d in range(
                min(-(-a_target // n_dev) * n_dev, n_pad),
                n_dev - 1, -n_dev,
            ):
                if n_pad % d == 0:
                    a_blk = d
                    break
            meta["msd_atoms_per_call"] = a_blk

        def chunked_step(positions, cells, volumes, species_idx,
                         cutoff_matrix, masses, weights):
            rdf = np.zeros(0)
            bad_c = bad_a = None
            cn_parts = []
            ovf_parts = []
            # dispatch every group BEFORE pulling any result: jax
            # dispatch is async, so the device computes group i+1
            # behind group i's output transfer instead of idling
            # through it
            pending = []
            for i in range(0, n_frames, fpc):
                k_cap = group_caps.get(i, self.max_neighbors)
                pending.append((i, k_cap, get_pair_step(k_cap)(
                    positions[i:i + fpc], cells[i:i + fpc],
                    volumes[i:i + fpc], species_idx, cutoff_matrix,
                    masses, weights[i:i + fpc],
                )))
            for i, k_cap, out in pending:
                # break-even vs the BAD-only rerun (which skips the
                # RDF pass): escalating the whole remembered group
                # to 2K only wins when over ~half its frames flag
                while (self.with_bad
                       and np.count_nonzero(
                           np.asarray(out["bad_overflow"])) > fpc // 2
                       and k_cap < 1024):
                    # dense overflow: this data genuinely needs a
                    # bigger table — escalate the whole group
                    k_cap *= 2
                    group_caps[i] = k_cap
                    out = get_pair_step(k_cap)(
                        positions[i:i + fpc], cells[i:i + fpc],
                        volumes[i:i + fpc], species_idx, cutoff_matrix,
                        masses, weights[i:i + fpc],
                    )
                if i == 0:
                    rdf = np.zeros(
                        np.asarray(out["rdf_counts"]).shape, np.float64
                    )
                    bad_c = np.zeros(
                        np.asarray(out["bad_concrete"]).shape, np.float64
                    )
                    bad_a = np.zeros(
                        np.asarray(out["bad_center_any"]).shape,
                        np.float64,
                    )
                rdf += np.asarray(out["rdf_counts"], np.float64)
                bad_c += np.asarray(out["bad_concrete"], np.float64)
                bad_a += np.asarray(out["bad_center_any"], np.float64)
                cn_parts.append(np.array(out["cn_counts"]))
                ovf_parts.append(np.array(out["bad_overflow"]))
            cn_all = np.concatenate(cn_parts)
            ovf_all = np.concatenate(ovf_parts)

            # rerun of flagged frames: they contributed ZERO to the BAD
            # sums (self-masked on device), so rerunning them at doubled
            # capacity and adding their histograms is exact. The rerun
            # step skips RDF entirely (with_rdf=False — RDF never uses
            # the neighbor table, so the first pass was complete); CN
            # rows (which the BAD table's verification pass emits,
            # exact only without overflow) are replaced. Block size is
            # the flagged count rounded up to a power-of-two multiple
            # of f_ax (capped at 16*f_ax): one dispatch covers the
            # common few-frame case without paying 16 frames of padded
            # compute when only one frame flagged, and at most ~5 block
            # shapes ever compile. Pads repeat the last frame at
            # weight 0.
            flagged = np.flatnonzero(ovf_all) if self.with_bad else []
            k_re = self.max_neighbors
            while len(flagged) and k_re < 1024:
                k_re *= 2
                still = []
                rb = f_ax
                while rb < min(len(flagged), 16 * f_ax):
                    rb *= 2
                for b in range(0, len(flagged), rb):
                    idx = flagged[b:b + rb]
                    n_live = len(idx)
                    idx_p = np.concatenate(
                        [idx, np.full(rb - n_live, idx[-1])]
                    ).astype(np.intp)
                    w = np.zeros(rb, positions.dtype)
                    w[:n_live] = weights[idx]
                    out = get_pair_step(k_re, with_rdf=False)(
                        positions[idx_p], cells[idx_p], volumes[idx_p],
                        species_idx, cutoff_matrix, masses, w,
                    )
                    bad_c += np.asarray(out["bad_concrete"], np.float64)
                    bad_a += np.asarray(
                        out["bad_center_any"], np.float64
                    )
                    ovf2 = np.asarray(out["bad_overflow"]) != 0
                    cn_re = np.asarray(out["cn_counts"])
                    for j, frame in enumerate(idx):
                        if ovf2[j]:
                            still.append(frame)  # self-masked again
                        else:
                            cn_all[frame] = cn_re[j]
                            ovf_all[frame] = 0
                flagged = np.asarray(still, dtype=np.int64)

            result = {
                "rdf_counts": rdf,
                "cn_counts": cn_all,
                "bad_concrete": bad_c,
                "bad_center_any": bad_a,
                # per-frame flags; all-False unless a frame still
                # overflowed at the runaway capacity bound (the sparse
                # rerun resolves ordinary misses)
                "bad_overflow": ovf_all,
            }
            if self.with_msd:
                # same async-dispatch pattern as the pair groups: queue
                # every block, then pull
                com_out = [
                    com_fn(positions[:, b:b + a_blk], masses[b:b + a_blk])
                    for b in range(0, n_pad, a_blk)
                ]
                com_s = np.zeros((n_frames, 3), np.float64)
                com_m = 0.0
                for s, m in com_out:
                    com_s += np.asarray(s, np.float64)
                    com_m += float(m)
                com = (com_s / com_m).astype(positions.dtype)
                msd_out = [
                    msd_fn(
                        positions[:, b:b + a_blk], masses[b:b + a_blk],
                        species_idx[b:b + a_blk], cells, com,
                    )
                    for b in range(0, n_pad, a_blk)
                ]
                sums = np.zeros((n_frames, n_species), np.float64)
                n_sp = np.zeros((n_species,), np.float64)
                for s, ns in msd_out:
                    sums += np.asarray(s, np.float64)
                    n_sp += np.asarray(ns, np.float64)
                origins = (n_frames - np.arange(n_frames)).astype(
                    np.float64
                )
                with np.errstate(invalid="ignore", divide="ignore"):
                    msd_sp = sums / (n_sp[None, :] * origins[:, None])
                    msd = sums.sum(axis=1) / (n_sp.sum() * origins)
                msd_sp[0] = 0.0
                msd[0] = 0.0
                result["msd_species"] = msd_sp.astype(np.float32)
                result["msd"] = msd.astype(np.float32)
            return result

        # the compiled pair programs, keyed (k_cap, with_rdf), for
        # callers that inspect them (memory analysis)
        chunked_step.pair_steps = pair_steps
        return chunked_step

    def run(self, batch, mesh=None) -> Dict[str, np.ndarray]:
        step_fn, args, meta = self.prepare(batch, mesh)
        out = step_fn(*args)
        out = {k: np.asarray(v) for k, v in out.items()}
        if self.with_bad and out["bad_overflow"].any():
            import logging

            logging.getLogger(__name__).warning(
                "BAD neighbor table flag: some atom exceeded "
                "max_neighbors=%d within cutoff, OR the sorted window "
                "(%s) failed its coverage check; angles were dropped. "
                "Raise max_neighbors, or widen/disable bad_window.",
                self.max_neighbors, self.bad_window,
            )
        return out, meta
