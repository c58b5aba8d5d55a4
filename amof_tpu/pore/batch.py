"""
Batched, mesh-sharded pore analysis — the scale path for ``-sa -vol``.

The reference runs Zeo++ once per frame under a joblib pool
(amof/pore/core.py:52-61); a per-frame in-process grid analysis would
pay one device dispatch per frame. This module compiles ONE
program that maps the full grid pipeline (distance field -> periodic
flood fill -> voxel volume integration -> per-atom surface sampling)
over every frame of a FrameBatch, sharded over the 'frames' axis of the
analysis mesh — the same SPMD shape as the fused RDF/BAD/CN/MSD step
(VERDICT r1 next #2).

Grid dims, window widths, and sample counts are static per trajectory
(computed conservatively over all frames, so NPT cells work); window
misses are detected exactly per frame and those frames are recomputed
through the exact per-frame path.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from amof_tpu.core.frames import as_frame_batch
from amof_tpu.data import elements
from amof_tpu.ops.pair_engine import matvec3
from amof_tpu.pore import grid_kernel
from amof_tpu.pore.zeopp import (
    A2_PER_A3_TO_M2_PER_CM3,
    A2_TO_M2,
    A3_TO_CM3,
    AMU_TO_G,
    DEFAULT_CHAN_RADIUS,
    DEFAULT_NUM_SAMPLES,
    DEFAULT_PROBE_RADIUS,
)

logger = logging.getLogger(__name__)


def _make_columns_frame_fn(
    radii,  # f32[N] constant
    dirs,  # f32[K, 3] constant
    col_plan: dict,
    surf_plan: dict,
    probe: float,
    chan: float,
    mc_points=None,  # (pts_tiled f32[T,P,3], weights f32[T,P], n_real)
    emit_faces: bool = False,
):
    """Per-frame traced function on the sorted-xy-column path:
    (pos, cell, volume) -> (asa, nasa, av, nav, missed).

    The fast default at production scale: probe-fit masks via
    ``void_masks_columns`` (full-z column tiles, unwrapped
    squared-distance threshold tests, no per-pair sqrt), Zeo++ MC
    -vol points riding the same candidate slices, and surface
    sampling + void classification fused in
    ``surface_valid_columns``.
    """
    grid = col_plan["grid"]
    n_vox = grid[0] * grid[1] * grid[2]
    k = dirs.shape[0]

    def frame_fn(args):
        pos, cell, volume = args
        inv_cell = jnp.linalg.inv(cell)
        frac = matvec3(pos, inv_cell)
        frac = frac - jnp.floor(frac)

        pts_tiled = None if mc_points is None else mc_points[0]
        # the z-chunked candidate windows (plan n_zc/wz/wzw) are not
        # passed: the full-run sweep is the default path
        m_probe, m_chan, fit_pts, miss_d = grid_kernel.void_masks_columns(
            frac, cell, radii, grid, probe=probe, chan=chan,
            nbx=col_plan["nbx"], nby=col_plan["nby"],
            window=col_plan["window"], pts_tiled=pts_tiled,
        )
        cls = grid_kernel.void_classification_mask(
            m_chan, return_faces=emit_faces
        )
        _, accessible, pocket = cls[:3]
        if probe != chan:
            acc_fit = m_probe & accessible
            poc_fit = m_probe & ~accessible
        else:
            acc_fit, poc_fit = accessible, pocket

        if mc_points is not None:
            _, w, n_real = mc_points
            acc_pt = grid_kernel.grid_lookup(accessible, pts_tiled, grid)
            av = volume * jnp.sum((fit_pts & acc_pt) * w) / n_real
            nav = volume * jnp.sum((fit_pts & ~acc_pt) * w) / n_real
        else:
            voxel_volume = volume / n_vox
            av = jnp.sum(acc_fit) * voxel_volume
            nav = jnp.sum(poc_fit) * voxel_volume

        # exact prefilter: points can only count on void voxels
        # (code = accessible + 2*pocket is nonzero exactly on
        # m_chan); chunks of all-buried atoms skip the blocker
        # pass — in a dense glass that is most of them
        valid, i_pt, i_nu, gis, rs, miss_s = (
            grid_kernel.surface_valid_columns(
                frac, cell, radii, probe, dirs, grid,
                nbx=surf_plan["nbx"], nby=surf_plan["nby"],
                window=surf_plan["window"],
                chunk=surf_plan["chunk"],
                col_cap=surf_plan["col_cap"],
                cand_mask=m_chan,
            )
        )
        acc_c, nacc_c = grid_kernel.classify_surface_points(
            valid, i_pt, i_nu, accessible, pocket
        )
        areas = jnp.where(
            gis >= 0, 4.0 * np.pi * (rs + probe) ** 2, 0.0
        )
        asa = jnp.sum(areas * acc_c) / k
        nasa = jnp.sum(areas * nacc_c) / k
        out = (
            asa.astype(jnp.float32), nasa.astype(jnp.float32),
            av.astype(jnp.float32), nav.astype(jnp.float32),
            miss_d | miss_s,
        )
        return out + (cls[3],) if emit_faces else out

    return frame_fn


def _make_frame_fn(
    radii,  # f32[N] constant
    dirs,  # f32[K, 3] constant
    grid,
    probe: float,
    chan: float,
    dist_window: Optional[int],
    dxa: float,
    surf_window: Optional[int],
    mc_samples=None,  # (pts f32[M,3] x-sorted, lo f32[C], hi f32[C],
    #                    window int) -> -vol via MC instead of voxels
    dist2=None,  # (tvx, tvy, nbx, k_slabs, window2, dya): two-level
    #              (x-slab, y-window) distance grid
    emit_faces: bool = False,
):
    """Per-frame traced function: (pos, cell, volume) ->
    (asa, nasa, av, nav, missed)."""
    n_vox = grid[0] * grid[1] * grid[2]
    dmax = max(probe, chan) + 1e-3

    def frame_fn(args):
        pos, cell, volume = args
        inv_cell = jnp.linalg.inv(cell)
        frac = matvec3(pos, inv_cell)
        frac = frac - jnp.floor(frac)

        if dist2 is not None:
            tvx, tvy, nbx, k_slabs, window2, dya = dist2
            dist, miss_d = grid_kernel.distance_grid_windowed2(
                frac, cell, radii, grid, dmax=dmax, dxa=dxa, dya=dya,
                tvx=tvx, tvy=tvy, nbx=nbx, k_slabs=k_slabs,
                window=window2,
            )
        elif dist_window is not None:
            # bound the [chunk, window] working set at ~16 MB
            dchunk = 2048 if dist_window <= 2048 else 1024
            dist, miss_d = grid_kernel.distance_grid_windowed(
                frac, cell, radii, grid, dmax=dmax, dxa=dxa,
                chunk=dchunk, window=dist_window,
            )
        else:
            dist = grid_kernel.distance_grid(frac, cell, radii, grid)
            miss_d = jnp.zeros((), bool)

        cls = grid_kernel.void_classification(
            dist, chan, return_faces=emit_faces
        )
        mask, accessible, pocket = cls[:3]
        if probe != chan:
            fit = dist >= probe
            acc_fit = fit & accessible
            poc_fit = fit & ~accessible
        else:
            acc_fit, poc_fit = accessible, pocket

        if mc_samples is not None:
            # Zeo++-faithful -vol: probe-fit test EXACTLY at MC sample
            # points (amof/pore/pysimmzeopp.py:127-128); only the
            # accessible/pocket split comes from the (possibly coarse)
            # connectivity grid
            pts, lo, hi, pwin = mc_samples
            d_pts, miss_p = grid_kernel.point_distance_windowed(
                frac, cell, radii, pts, lo, hi,
                dmax=probe + 1e-3, dxa=dxa, chunk=2048, window=pwin,
            )
            miss_d = miss_d | miss_p
            fit_pt = d_pts >= probe
            acc_pt = grid_kernel.grid_lookup(accessible, pts, grid)
            m_tot = pts.shape[0]
            av = volume * jnp.sum(fit_pt & acc_pt) / m_tot
            nav = volume * jnp.sum(fit_pt & ~acc_pt) / m_tot
        else:
            voxel_volume = volume / n_vox
            av = jnp.sum(acc_fit) * voxel_volume
            nav = jnp.sum(poc_fit) * voxel_volume

        if surf_window is not None:
            a_s, n_s, _, r_sorted, miss_s = (
                grid_kernel.surface_point_classification_windowed(
                    frac, cell, radii, probe, dirs, accessible, pocket,
                    grid, window=surf_window,
                )
            )
            areas = 4.0 * np.pi * (r_sorted + probe) ** 2
        else:
            a_s, n_s = grid_kernel.surface_point_classification(
                frac, cell, radii, probe, dirs, accessible, pocket, grid
            )
            areas = 4.0 * np.pi * (radii + probe) ** 2
            miss_s = jnp.zeros((), bool)
        k = dirs.shape[0]
        asa = jnp.sum(areas * a_s) / k
        nasa = jnp.sum(areas * n_s) / k
        out = (
            asa.astype(jnp.float32), nasa.astype(jnp.float32),
            av.astype(jnp.float32), nav.astype(jnp.float32),
            miss_d | miss_s,
        )
        return out + (cls[3],) if emit_faces else out

    return frame_fn


class BatchedPore:
    """Compiled -sa/-vol pore analysis over a FrameBatch on a mesh."""

    def __init__(
        self,
        probe_radius: float = DEFAULT_PROBE_RADIUS,
        chan_radius: float = DEFAULT_CHAN_RADIUS,
        num_samples: int = DEFAULT_NUM_SAMPLES,
        radii: Optional[Dict[str, float]] = None,
        resolution: float = 0.2,
        grid: Optional[tuple] = None,
        window="auto",
        frames_per_call: int = 64,
        vol_method: str = "grid",
        conn_resolution: Optional[float] = None,
        window_scale: float = 1.0,
        winding: str = "face",
    ):
        self.probe_radius = float(probe_radius)
        self.chan_radius = float(chan_radius)
        self.num_samples = int(num_samples)
        self.radii = radii
        self.resolution = float(resolution)
        self.grid = grid
        self.window = window
        # vol_method "mc" evaluates -vol at num_samples MC points with
        # EXACT probe-fit tests (Zeo++'s own estimator,
        # amof/pore/pysimmzeopp.py:127-128); the grid then only decides
        # the accessible/pocket split, so it can be coarser
        # (conn_resolution, default = resolution).
        # ACCURACY CAVEAT (measured): a voxel whose CENTER is blocked
        # seals the whole voxel, so coarse connectivity grids close
        # passages narrower than ~one voxel and systematically
        # UNDER-report accessibility near the percolation threshold
        # (a borderline channel was classified open at <= 0.3 A and
        # sealed at >= 0.35 A in a 300-atom test glass). Keep
        # conn_resolution = resolution (the default) for near-critical
        # systems; coarse grids are exact when channels/pockets are
        # comfortably wider or narrower than the probe.
        if vol_method not in ("grid", "mc"):
            raise ValueError(f"vol_method must be 'grid' or 'mc', got "
                             f"{vol_method!r}")
        self.vol_method = vol_method
        self.conn_resolution = (
            float(conn_resolution) if conn_resolution else None
        )
        # one device dispatch covers at most this many frames, so a long
        # trajectory never becomes one multi-minute program while the
        # per-dispatch overhead is still amortized over many frames
        self.frames_per_call = int(frames_per_call)
        # internal: widened-window retry factor for frames whose
        # sorted-run capacities missed (run() escalates 1 -> 2 -> 4 so
        # a trajectory's -vol column stays ONE estimator instead of
        # mixing MC with the fine-grid fallback)
        self.window_scale = float(window_scale)
        # winding="face": the device same-label face test — exact for
        # every single-wrap channel (all practical zeolite/MOF cases).
        # winding="exact": the device pass additionally emits each
        # frame's wrap-edge label pairs; the host displacement-vector
        # analysis (pore/winding.py, Zeo++'s criterion) then CERTIFIES
        # the face test per frame and recomputes any frame with a
        # multi-wrap composite channel through the exact per-frame
        # path. Zero device-side extra work; the certificate transfer
        # costs one extra output array per dispatch.
        if winding not in ("face", "exact"):
            raise ValueError(
                f"winding must be 'face' or 'exact', got {winding!r}"
            )
        self.winding = winding

    def prepare(self, batch, mesh=None):
        """Resolve static shapes; returns (step_fn, args, meta)."""
        from amof_tpu.parallel.mesh import analysis_mesh

        batch = as_frame_batch(batch)
        mesh = mesh or analysis_mesh(n_frames=batch.num_frames)
        if batch.num_frames % mesh.shape["frames"]:
            raise ValueError(
                f"frame count ({batch.num_frames}) not divisible by the "
                f"mesh 'frames' axis ({mesh.shape['frames']})"
            )
        cells = np.asarray(batch.cell, np.float64)
        rad_table = elements.vdw_radius_array(overrides=self.radii)
        radii = rad_table[np.asarray(batch.species)].astype(np.float32)
        n_at = len(radii)
        volumes = np.abs(np.linalg.det(cells)).astype(np.float32)
        masses = elements.mass_of(np.asarray(batch.species))
        mass_amu = float(np.sum(masses))

        # static grid dims: conservative per-axis max over NPT frames
        from amof_tpu.pore.zeopp import _grid_dims

        if self.grid is None:
            res = (
                self.conn_resolution
                if (self.vol_method == "mc" and self.conn_resolution)
                else self.resolution
            )
            grid = _grid_dims(
                np.linalg.norm(cells, axis=2).max(axis=0)[:, None]
                * np.eye(3),
                res,
            )
        else:
            grid = tuple(self.grid)

        probe, chan = self.probe_radius, self.chan_radius
        dmax = max(probe, chan) + 1e-3

        # three-level column path (the fast default): probe-fit masks,
        # tile-riding MC points, and column surface sampling. Applies
        # whenever the cell is big enough for >= 4x4 reach-wide
        # columns and the user did not pin explicit grid dims (the
        # column plan adjusts dims for tile divisibility).
        # Directions per atom follow Zeo++'s allocation (num_samples
        # spread over ALL atom spheres, ~5/atom at 10k atoms,
        # amof/pore/pysimmzeopp.py:119-125); the floor of 8
        # deterministic Fibonacci directions stays ~1.6x above that
        # default sampling density — raise num_samples for more.
        k = max(8, self.num_samples // max(1, n_at))
        dirs = grid_kernel.fibonacci_sphere(k)
        col_plan = surf_plan = None
        if self.grid is None and self.window is not None:
            col_plan = grid_kernel.xycol_plan(
                cells, float(radii.max()), dmax, grid, n_at
            )
            if col_plan is not None:
                surf_plan = grid_kernel.surface_plan(
                    cells, float(radii.max()), probe, n_at
                )
        if col_plan is not None and surf_plan is not None:
            if self.window_scale != 1.0:
                col_plan["window"] = int(
                    -(-col_plan["window"] * self.window_scale // 8) * 8
                )
                # the z-chunk capacities (wz/wzw) were sized for the
                # original window; disable the z path rather than carry
                # stale capacities into a widened retry
                col_plan["n_zc"] = 0
                surf_plan["window"] = int(
                    -(-surf_plan["window"] * self.window_scale // 8) * 8
                )
                surf_plan["col_cap"] = int(
                    -(-surf_plan["col_cap"] * self.window_scale
                      // surf_plan["chunk"]) * surf_plan["chunk"]
                )
            grid = col_plan["grid"]
            mc_points = None
            if self.vol_method == "mc":
                rng = np.random.default_rng(20240817)
                pts = rng.random((self.num_samples, 3)).astype(np.float32)
                pts_tiled, w = grid_kernel.assign_points_to_xytiles(
                    pts, col_plan
                )
                mc_points = (
                    jnp.asarray(pts_tiled), jnp.asarray(w),
                    float(self.num_samples),
                )
            frame_fn = _make_columns_frame_fn(
                jnp.asarray(radii), jnp.asarray(dirs), col_plan,
                surf_plan, probe, chan, mc_points=mc_points,
                emit_faces=self.winding == "exact",
            )
            return self._finalize(batch, mesh, frame_fn, grid, {
                "col_plan": col_plan, "surf_plan": surf_plan, "k": k,
                "mass_amu": mass_amu, "volumes": volumes,
                "dist_window": None, "surf_window": None, "dist2": None,
            })

        # sorted-window sizing (static, conservative over frames):
        # same estimates as zeopp.analyze_frame but with the min slab
        # width across the trajectory
        bxc = np.cross(cells[:, 1], cells[:, 2])
        w0 = float(
            (np.abs(np.einsum("fi,fi->f", cells[:, 0], bxc))
             / np.linalg.norm(bxc, axis=1)).min()
        )
        dxa = float(
            np.ceil((dmax + float(radii.max())) / w0 / 5e-3) * 5e-3
        )
        dist_window = surf_window = None
        if self.window is not None:
            chunk = 2048  # pessimistic span for the adaptive chunk
            span = (chunk // (grid[1] * grid[2]) + 2) / grid[0]
            if self.window == "auto":
                w_est = (
                    1.3 * n_at * (span + 2 * dxa) + 64
                ) * self.window_scale
                dist_window = int(-(-w_est // 128) * 128)
            else:
                dist_window = int(self.window * self.window_scale)
            if dist_window >= n_at:
                dist_window = None
            reach = 2.0 * (float(radii.max()) + probe)
            w_est = (
                1.3 * n_at * reach / w0 + 64  # reach spans R_i+R_j+2p
            ) * self.window_scale
            surf_window = int(-(-w_est // 128) * 128)
            if 32 + 2 * surf_window >= n_at:
                surf_window = None

        # two-level (x-slab, y-window) upgrade for the distance grid:
        # engaged when its candidate work beats the one-level window
        dist2 = None
        if self.window == "auto" and dist_window is not None:
            cxa = np.cross(cells[:, 2], cells[:, 0])
            w0y = float(
                (np.abs(np.einsum("fi,fi->f", cells[:, 1], cxa))
                 / np.linalg.norm(cxa, axis=1)).min()
            )
            dya = float(
                np.ceil((dmax + float(radii.max())) / w0y / 5e-3) * 5e-3
            )
            tvx = next((t for t in (8, 4) if grid[0] % t == 0), None)
            tvy = next((t for t in (16, 8, 4) if grid[1] % t == 0), None)
            if tvx and tvy:
                nbx = max(2, min(64, int(1 / (2 * dxa)) or 2))
                rx = (tvx - 1) / grid[0] + 2 * dxa
                ry = (tvy - 1) / grid[1] + 2 * dya
                k_slabs = int(np.ceil(rx * nbx)) + 1
                if ry < 0.99 and k_slabs <= nbx:
                    w_est = 1.3 * n_at * ry / nbx + 64
                    window2 = int(-(-w_est // 128) * 128)
                    # tile bookkeeping costs real time: engage only
                    # on a decisive (2x) candidate-work advantage
                    if k_slabs * window2 * 2 < dist_window:
                        dist2 = (tvx, tvy, nbx, k_slabs, window2, dya)

        mc_samples = None
        if self.vol_method == "mc":
            # one seeded sample set serves every frame (frames are
            # independent estimates; the sampling error is Zeo++'s own
            # ~sqrt(p(1-p)/num_samples))
            chunk_pts = 2048
            m = -(-self.num_samples // chunk_pts) * chunk_pts
            rng = np.random.default_rng(20240817)
            pts = rng.random((m, 3)).astype(np.float32)
            pts = pts[np.argsort(pts[:, 0], kind="stable")]
            lo = np.ascontiguousarray(pts[::chunk_pts, 0])
            hi = np.ascontiguousarray(pts[chunk_pts - 1::chunk_pts, 0])
            span = float((hi - lo).max())
            pwin_est = 1.3 * n_at * (span + 2 * dxa) + 64
            pwin = int(-(-pwin_est // 128) * 128)
            mc_samples = (
                jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi), pwin,
            )

        frame_fn = _make_frame_fn(
            jnp.asarray(radii), jnp.asarray(dirs), grid, probe, chan,
            dist_window, dxa, surf_window, mc_samples=mc_samples,
            dist2=dist2, emit_faces=self.winding == "exact",
        )
        return self._finalize(batch, mesh, frame_fn, grid, {
            "mass_amu": mass_amu, "volumes": volumes,
            "dist_window": dist_window, "surf_window": surf_window,
            "k": k, "dist2": dist2, "col_plan": None, "surf_plan": None,
        })

    def _finalize(self, batch, mesh, frame_fn, grid, extra_meta):
        """Shared tail of prepare(): shard-map the per-frame fn over
        the mesh, chunk dispatches, and assemble (step_fn, args, meta).
        """
        volumes = extra_meta["volumes"]
        emit_faces = self.winding == "exact"

        def step(positions, cells_f, volumes_f):
            out = jax.lax.map(frame_fn, (positions, cells_f, volumes_f))
            # ONE stacked output array per dispatch (one transfer);
            # rows are (asa, nasa, av, nav, missed)
            stacked = jnp.stack([
                out[0], out[1], out[2], out[3],
                out[4].astype(jnp.float32),
            ])
            if emit_faces:
                return stacked, out[5]  # faces i32[F_loc, 2, n_face]
            return stacked

        step_fn = jax.jit(
            shard_map(
                step, mesh=mesh,
                in_specs=(P("frames"), P("frames"), P("frames")),
                out_specs=(
                    (P(None, "frames"), P("frames")) if emit_faces
                    else P(None, "frames")
                ),
                check_vma=False,
            )
        )

        # frames per dispatch: a multiple of the mesh frames axis that
        # divides the frame count (one compiled shape), capped near
        # frames_per_call * frames_axis
        n_frames = batch.num_frames
        f_ax = mesh.shape["frames"]
        target = max(self.frames_per_call, 1) * f_ax
        fpc = f_ax
        for d in range(min(target, n_frames), f_ax - 1, -f_ax):
            if n_frames % d == 0:
                fpc = d
                break

        def chunked_step(positions, cells_f, volumes_f):
            # dispatch every chunk before pulling any (async dispatch:
            # chunk i+1 computes behind chunk i's output transfer)
            outs = [
                step_fn(
                    positions[i:i + fpc], cells_f[i:i + fpc],
                    volumes_f[i:i + fpc],
                )
                for i in range(0, n_frames, fpc)
            ]
            if emit_faces:
                faces = np.concatenate(
                    [np.asarray(o[1]) for o in outs], axis=0
                )  # [n_frames, 2, n_face]
                outs = [o[0] for o in outs]
            stacked = np.concatenate(
                [np.asarray(o) for o in outs], axis=1
            )  # [5, n_frames]
            out5 = tuple(stacked[j] for j in range(4)) + (
                stacked[4] != 0,
            )
            return out5 + (faces,) if emit_faces else out5

        # the compiled per-dispatch program, for callers that inspect
        # it (memory analysis)
        chunked_step.step_fn = step_fn

        args = (
            np.asarray(batch.positions, np.float32),
            np.asarray(batch.cell, np.float32),
            volumes,
        )
        meta = {
            "grid": grid, "mesh": mesh, "frames_per_call": fpc,
            **extra_meta,
        }
        return chunked_step, args, meta

    def run(self, batch, mesh=None):
        """Returns (records, meta): one dict of Zeo++ -sa/-vol output
        fields per frame (amof/pore/core.py:70-82 field names)."""
        batch = as_frame_batch(batch)
        step_fn, args, meta = self.prepare(batch, mesh)
        return self.records(batch, step_fn(*args), meta)

    def records(self, batch, out, meta):
        """(records, meta) from the output of a ``prepare`` step on
        ``batch``: frames whose windows missed (or whose face test a
        composite channel defeats) are recomputed, then every frame is
        converted to Zeo++ -sa/-vol fields."""
        batch = as_frame_batch(batch)
        faces = out[5] if self.winding == "exact" else None
        # np.array (not asarray): numpy views of JAX arrays are
        # read-only and missed frames are patched in place below
        asa, nasa, av, nav, missed = (np.array(v) for v in out[:5])
        missed = missed.astype(bool)
        if missed.any():
            idx = np.nonzero(missed)[0]
            if self.vol_method == "mc" and self.window_scale < 4:
                # widened-window retry keeps the -vol column ONE
                # estimator across the trajectory (the fine-grid
                # fallback converges to the same value but mixing MC
                # and grid estimates within one column is avoidable)
                logger.info(
                    "sorted-run capacity missed on %d/%d frames; "
                    "retrying them with %gx windows",
                    len(idx), len(missed), self.window_scale * 2,
                )
                retry = BatchedPore(
                    probe_radius=self.probe_radius,
                    chan_radius=self.chan_radius,
                    num_samples=self.num_samples, radii=self.radii,
                    resolution=self.resolution, grid=self.grid,
                    window=self.window,
                    frames_per_call=self.frames_per_call,
                    vol_method=self.vol_method,
                    conn_resolution=self.conn_resolution,
                    window_scale=self.window_scale * 2,
                    winding=self.winding,
                )
                sub = batch._replace(
                    positions=np.asarray(batch.positions)[idx],
                    cell=np.asarray(batch.cell)[idx],
                    step=np.asarray(batch.step)[idx],
                )
                from amof_tpu.parallel.mesh import analysis_mesh

                sub_records, _ = retry.run(
                    sub, mesh=analysis_mesh(n_frames=len(idx))
                )
                for j, i in enumerate(idx):
                    asa[i] = sub_records[j]["ASA_A^2"]
                    nasa[i] = sub_records[j]["NASA_A^2"]
                    av[i] = sub_records[j]["AV_A^3"]
                    nav[i] = sub_records[j]["NAV_A^3"]
            else:
                # window misses are exact flags; recompute those frames
                # through the unwindowed per-frame path
                from amof_tpu.pore import zeopp

                logger.info(
                    "sorted-window capacity missed on %d/%d frames; "
                    "recomputing them exactly", len(idx), len(missed),
                )
                for i in idx:
                    out = zeopp.analyze_frame(
                        batch.frame(int(i)), sa=True, vol=True,
                        probe_radius=self.probe_radius,
                        chan_radius=self.chan_radius,
                        num_samples=self.num_samples, radii=self.radii,
                        resolution=self.resolution,
                        # grid mode re-runs at the identical grid; the
                        # (rare) mc-mode terminal fallback integrates
                        # on the fine grid (converges to the MC value)
                        grid=meta["grid"] if self.vol_method == "grid"
                        else None,
                        window=None,
                    )
                    asa[i], nasa[i] = out["ASA_A^2"], out["NASA_A^2"]
                    av[i], nav[i] = out["AV_A^3"], out["NAV_A^3"]

        if faces is not None:
            # winding="exact": the host displacement-vector analysis
            # certifies the device face test from each frame's
            # wrap-edge label pairs; a frame with a winding cluster the
            # face test missed (multi-wrap composite channel) is
            # recomputed through the exact per-frame path. Frames the
            # miss fallback already recomputed went through that exact
            # path and are skipped. Estimator note: in mc mode the
            # recompute integrates -vol on the fine grid (the exotic
            # frame's column value converges to, but is not drawn from,
            # the MC estimator) — logged above, and only reachable on
            # multi-wrap composite-channel frames.
            from amof_tpu.pore import winding as _winding
            from amof_tpu.pore import zeopp

            axis_ids = grid_kernel.face_axis_ids(meta["grid"])
            flagged = [
                i for i in range(len(missed))
                if not missed[i]
                and not _winding.face_test_is_exact(faces[i], axis_ids)
            ]
            if flagged:
                logger.info(
                    "face test missed a composite channel on %d/%d "
                    "frames; recomputing them with the exact winding "
                    "analysis", len(flagged), len(missed),
                )
            for i in flagged:
                out = zeopp.analyze_frame(
                    batch.frame(int(i)), sa=True, vol=True,
                    probe_radius=self.probe_radius,
                    chan_radius=self.chan_radius,
                    num_samples=self.num_samples, radii=self.radii,
                    resolution=self.resolution,
                    grid=meta["grid"] if self.vol_method == "grid"
                    else None,
                    window=None,
                )
                asa[i], nasa[i] = out["ASA_A^2"], out["NASA_A^2"]
                av[i], nav[i] = out["AV_A^3"], out["NAV_A^3"]

        volume = meta["volumes"].astype(np.float64)
        mass_g = meta["mass_amu"] * AMU_TO_G
        records = []
        for i in range(len(av)):
            records.append({
                "Unitcell_volume": float(volume[i]),
                "Density": mass_g / (float(volume[i]) * A3_TO_CM3),
                "ASA_A^2": float(asa[i]),
                "ASA_m^2/cm^3": float(asa[i]) / float(volume[i])
                * A2_PER_A3_TO_M2_PER_CM3,
                "ASA_m^2/g": float(asa[i]) * A2_TO_M2 / mass_g,
                "NASA_A^2": float(nasa[i]),
                "NASA_m^2/cm^3": float(nasa[i]) / float(volume[i])
                * A2_PER_A3_TO_M2_PER_CM3,
                "NASA_m^2/g": float(nasa[i]) * A2_TO_M2 / mass_g,
                "AV_A^3": float(av[i]),
                "AV_Volume_fraction": float(av[i]) / float(volume[i]),
                "AV_cm^3/g": float(av[i]) * A3_TO_CM3 / mass_g,
                "NAV_A^3": float(nav[i]),
                "NAV_Volume_fraction": float(nav[i]) / float(volume[i]),
                "NAV_cm^3/g": float(nav[i]) * A3_TO_CM3 / mass_g,
            })
        return records, meta
