"""
On-device pore geometry: distance grid, periodic flood fill, percolation.

This is the device replacement for the Zeo++ ``network`` binary's
Voronoi/MC analysis (amof/pore/pysimmzeopp.py; SURVEY.md §2 native
checklist #3). Pipeline per frame:

  1. rasterize the cell into a voxel grid and compute the distance field
     d(x) = min_i (|x - r_i|_mic - R_i)  (distance to the nearest atom
     surface; triclinic minimum image);
  2. probe-fit mask  M_r = { d >= r_probe }  (positions where the probe
     center can sit);
  3. connected-component labeling of M_r with 6-connectivity, twice:
     once open (no wrap) and once periodic;
  4. percolation: an open component that touches itself across a
     periodic face has winding number != 0 — it is an infinite channel.
     Channel status is then propagated through periodic connectivity, so
     every void voxel is classified accessible (channel-connected) or
     non-accessible (isolated pocket) — Zeo++'s ASA/NASA / AV/NAV split.

Everything is shape-static (grid dims fixed per trajectory) and runs
under jit; the flood fill is a lax.while_loop of masked max-propagation
steps (8 sweeps per convergence check).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from amof_tpu.ops.pair_engine import matvec3


@functools.partial(jax.jit, static_argnames=("grid", "chunk"))
def distance_grid(frac_atoms, cell, radii, grid, chunk=65536):
    """Distance-to-nearest-atom-surface field on a fractional voxel grid.

    Args:
        frac_atoms: f32[N, 3] fractional atom positions (may include
            padding rows with radius -inf ... use radius -1e9 to ignore).
        cell: f32[3, 3] lattice (row vectors).
        radii: f32[N] atom radii (Å); use -1e9 for padding rows.
        grid: (Gx, Gy, Gz) static voxel counts.

    Returns:
        f32[Gx, Gy, Gz] distance field in Å.
    """
    gx, gy, gz = grid
    n_vox = gx * gy * gz
    ii = (jnp.arange(gx) + 0.5) / gx
    jj = (jnp.arange(gy) + 0.5) / gy
    kk = (jnp.arange(gz) + 0.5) / gz
    vf = jnp.stack(jnp.meshgrid(ii, jj, kk, indexing="ij"), axis=-1).reshape(
        n_vox, 3
    )

    def chunk_min(c0):
        v = jax.lax.dynamic_slice(vf, (c0, 0), (chunk, 3))  # [C, 3]
        df = v[:, None, :] - frac_atoms[None, :, :]  # [C, N, 3]
        df = df - jnp.floor(df + 0.5)
        dc = matvec3(df, cell)
        d = jnp.sqrt(jnp.sum(dc * dc, axis=-1)) - radii[None, :]
        return jnp.min(d, axis=1)

    pad = (-n_vox) % chunk
    if pad:
        vf = jnp.concatenate([vf, jnp.zeros((pad, 3), vf.dtype)], axis=0)
    starts = jnp.arange(0, n_vox + pad, chunk)
    d = jax.lax.map(chunk_min, starts).reshape(-1)[:n_vox]
    return d.reshape(gx, gy, gz)


@functools.partial(
    jax.jit, static_argnames=("grid", "dmax", "dxa", "chunk", "window")
)
def distance_grid_windowed(
    frac_atoms,  # f32[N, 3], NO padding rows
    cell,
    radii,  # f32[N]
    grid,
    dmax: float,
    dxa: float,  # fractional-x reach: (dmax + max radius) / slab width
    chunk: int = 1024,
    window: int = 1536,
):
    """Clamped distance field: exact wherever the true value < ``dmax``.

    The probe-accessibility masks only compare d against probe radii, so
    values above ``dmax`` = max(probe, chan) + eps are interchangeable —
    and then each voxel only needs atoms within ``dmax`` + R of it.
    Voxel chunks are x-major (contiguous linear indices span few
    x-planes), so after sorting atoms by fractional x each chunk tests a
    ``window``-wide slice of sorted order instead of all N atoms —
    O(V * W) instead of O(V * N).

    The window is verified, not assumed: the number of atoms whose
    fractional x falls in each chunk's reach is counted exactly
    (vectorized searchsorted), and any chunk needing more than
    ``window`` raises the returned flag (caller falls back to
    ``distance_grid``).

    Returns:
        (f32[Gx, Gy, Gz] field clamped at dmax, missed bool[])
    """
    gx, gy, gz = grid
    n = frac_atoms.shape[0]
    assert window < n, "window must be smaller than the atom count"
    n_vox = gx * gy * gz
    ii = (jnp.arange(gx) + 0.5) / gx
    jj = (jnp.arange(gy) + 0.5) / gy
    kk = (jnp.arange(gz) + 0.5) / gz
    vf = jnp.stack(jnp.meshgrid(ii, jj, kk, indexing="ij"), axis=-1).reshape(
        n_vox, 3
    )
    pad = (-n_vox) % chunk
    if pad:
        vf = jnp.concatenate([vf, jnp.zeros((pad, 3), vf.dtype)], axis=0)
    n_chunks = (n_vox + pad) // chunk

    # sort atoms by wrapped fractional x, payloads carried through
    fx = frac_atoms[:, 0] - jnp.floor(frac_atoms[:, 0])
    xs, ax, ay, az, rs = jax.lax.sort(
        (fx, frac_atoms[:, 0], frac_atoms[:, 1], frac_atoms[:, 2], radii),
        dimension=0, num_keys=1,
    )
    ext = lambda a: jnp.concatenate([a, a])  # circular windows
    ext_x, ext_y, ext_z, ext_r = ext(ax), ext(ay), ext(az), ext(rs)

    # per-chunk fractional-x reach [lo, hi] (static) -> sorted-order
    # start + exact in-reach count (dynamic, vectorized binary search)
    c0 = np.arange(n_chunks) * chunk
    ix_lo = c0 // (gy * gz)
    ix_hi = (c0 + chunk - 1) // (gy * gz)
    lo = (ix_lo + 0.5) / gx - dxa
    hi = (ix_hi + 0.5) / gx + dxa
    if float((hi - lo).max()) >= 1.0:
        # reach covers the whole cell: no window exists
        return (
            jnp.minimum(distance_grid(frac_atoms, cell, radii, grid), dmax),
            jnp.zeros((), bool),
        )
    s_idx = jnp.searchsorted(xs, jnp.asarray(lo % 1.0, xs.dtype))
    e_idx = jnp.searchsorted(xs, jnp.asarray(hi % 1.0, xs.dtype))
    cnt = jnp.where(
        jnp.asarray(hi % 1.0 >= lo % 1.0), e_idx - s_idx,
        e_idx + (n - s_idx),
    )
    missed = jnp.any(cnt > window)

    def chunk_min(args):
        c, s = args
        v = jax.lax.dynamic_slice(vf, (c, 0), (chunk, 3))  # [C, 3]
        wx = jax.lax.dynamic_slice(ext_x, (s,), (window,))
        wy = jax.lax.dynamic_slice(ext_y, (s,), (window,))
        wz = jax.lax.dynamic_slice(ext_z, (s,), (window,))
        wr = jax.lax.dynamic_slice(ext_r, (s,), (window,))
        wf = jnp.stack([wx, wy, wz], axis=-1)  # [W, 3]
        df = v[:, None, :] - wf[None, :, :]
        df = df - jnp.floor(df + 0.5)
        dc = matvec3(df, cell)
        d = jnp.sqrt(jnp.sum(dc * dc, axis=-1)) - wr[None, :]
        return jnp.minimum(jnp.min(d, axis=1), dmax)

    starts = jnp.arange(0, n_vox + pad, chunk)
    d = jax.lax.map(chunk_min, (starts, s_idx)).reshape(-1)[:n_vox]
    return d.reshape(gx, gy, gz), missed


def _neighbor_max(labels, mask, periodic: bool):
    """One 6-neighbor max-propagation sweep over the masked region."""
    out = labels
    for axis in range(3):
        for shift in (1, -1):
            rolled = jnp.roll(labels, shift, axis=axis)
            if not periodic:
                # zero out the contribution that wrapped around
                idx = 0 if shift == 1 else labels.shape[axis] - 1
                rolled = _set_slice(rolled, axis, idx, -1)
            out = jnp.maximum(out, rolled)
    return jnp.where(mask, out, -1)


def _set_slice(arr, axis, idx, value):
    sl = [slice(None)] * 3
    sl[axis] = idx
    return arr.at[tuple(sl)].set(value)


@functools.partial(jax.jit, static_argnames=("periodic", "sweeps"))
def label_components(mask, periodic: bool = True, sweeps: int = 8):
    """Connected-component labels of a 3-d boolean mask (6-connectivity).

    Labels are voxel linear indices propagated to their component max;
    -1 outside the mask. ``periodic`` toggles wrap-around adjacency.
    """
    gx, gy, gz = mask.shape
    init = jnp.where(
        mask, jnp.arange(gx * gy * gz, dtype=jnp.int32).reshape(mask.shape), -1
    )
    return _propagate_fixpoint(init, periodic, sweeps)


def _propagate_seeded(init, periodic: bool, sweeps: int = 8,
                      levels: int = 2, min_coarse: int = 16):
    """Coarse-to-fine seeded masked max-propagation — exact multigrid
    seeding for the flood-fill fixpoint.

    The coarse cell mask keeps a cell open only when ALL 8 children are
    open, so coarse adjacency implies fine connectivity: two
    face-adjacent all-open cells have their 16 children mutually
    connected. The coarse init is the max of each open cell's children,
    so the coarse fixpoint computes, per cell, the max init over a
    SUBSET of the cell's fine component — a valid monotone seed
    (init <= seed <= component max). Running the fine fixpoint from
    max(init, seed) therefore converges to exactly the same labels.

    Truncated rows of odd axes get no seed, and the coarse pass drops
    periodic wrap unless every axis halves exactly — both only
    UNDER-seed, which the exact fine fixpoint completes.

    Production paths call ``_propagate_fixpoint`` directly: for the
    LABEL stage the component max usually sits in the 1-voxel boundary
    shell that the all-children coarsening cannot cover, so the max
    still propagates at fine-grid speed and the coarse pass buys few
    rounds. Kept (with bit-exactness tests, TestMultigridSeeding)
    because the seeding IS sound and would pay off on propagation
    problems whose seeds are value-free (binary reachability on
    thick-channel masks).
    """
    gx, gy, gz = init.shape
    cx, cy, cz = gx // 2, gy // 2, gz // 2
    if levels <= 0 or min(cx, cy, cz) < min_coarse:
        return _propagate_fixpoint(init, periodic, sweeps)
    t = init[: 2 * cx, : 2 * cy, : 2 * cz].reshape(cx, 2, cy, 2, cz, 2)
    cmask = (t >= 0).all(axis=(1, 3, 5))
    cinit = jnp.where(cmask, t.max(axis=(1, 3, 5)), -1)
    cper = periodic and (gx, gy, gz) == (2 * cx, 2 * cy, 2 * cz)
    clab = _propagate_seeded(
        cinit, cper, sweeps, levels=levels - 1, min_coarse=min_coarse
    )[:cx]
    seed = jnp.repeat(
        jnp.repeat(jnp.repeat(clab, 2, axis=0), 2, axis=1), 2, axis=2
    )
    seed = jnp.pad(
        seed,
        ((0, gx - 2 * cx), (0, gy - 2 * cy), (0, gz - 2 * cz)),
        constant_values=-1,
    )
    return _propagate_fixpoint(jnp.maximum(init, seed), periodic, sweeps)


@jax.jit
def percolating_flags(open_labels, mask):
    """Per-voxel flag: does this voxel's OPEN component wind around any
    periodic axis? (same open label adjacent across a periodic face
    => infinite channel)."""
    n = open_labels.size
    flag = jnp.zeros(n + 1, jnp.bool_)

    for axis in range(3):
        sl_last = [slice(None)] * 3
        sl_last[axis] = -1
        sl_first = [slice(None)] * 3
        sl_first[axis] = 0
        a = open_labels[tuple(sl_last)].reshape(-1)
        b = open_labels[tuple(sl_first)].reshape(-1)
        wins = (a == b) & (a >= 0)
        flag = flag.at[jnp.where(wins, a, n)].max(wins)
    return flag[open_labels.reshape(-1)].reshape(open_labels.shape) & mask


@functools.partial(jax.jit, static_argnames=("sweeps",))
def propagate_channel(channel_seed, mask, sweeps: int = 8):
    """Extend channel membership through periodic connectivity so every
    voxel periodically connected to a winding component is accessible."""
    seed = jnp.where(channel_seed, 1, jnp.where(mask, 0, -1)).astype(jnp.int32)
    return _propagate_fixpoint(seed, True, sweeps) == 1


@jax.jit
def winding_seeds(open_labels, mask):
    """Voxels on a periodic face where the OPEN component meets itself
    across the wrap (label equal on opposite faces) — a seed set that
    intersects every winding (infinite-channel) component. Scatter-free:
    ``percolating_flags`` builds the same information through a
    voxel-count-sized scatter-max; the subsequent periodic flood fill
    spreads seeds through the whole component anyway, so face seeds are
    sufficient."""
    seeds = jnp.zeros(mask.shape, bool)
    for axis in range(3):
        sl_last = [slice(None)] * 3
        sl_last[axis] = -1
        sl_first = [slice(None)] * 3
        sl_first[axis] = 0
        a = open_labels[tuple(sl_last)]
        b = open_labels[tuple(sl_first)]
        wins = (a == b) & (a >= 0)
        seeds = seeds.at[tuple(sl_last)].set(
            seeds[tuple(sl_last)] | wins
        )
        seeds = seeds.at[tuple(sl_first)].set(
            seeds[tuple(sl_first)] | wins
        )
    return seeds & mask


def void_classification(dist, r_probe, return_faces: bool = False):
    """(mask, accessible, pocket) voxel masks for a probe radius."""
    return void_classification_mask(dist >= r_probe, return_faces)


def void_classification_mask(mask, return_faces: bool = False):
    """(mask, accessible, pocket) from a precomputed probe-fit mask.

    With ``return_faces`` additionally returns the wrap-edge label
    pairs (``face_label_pairs`` of the open labels) so a host pass can
    run the fully general displacement-vector winding analysis
    (pore/winding.py) and certify — or correct — the face test's
    classification per frame (BatchedPore(winding="exact"))."""
    open_labels = label_components(mask, periodic=False)
    seeds = winding_seeds(open_labels, mask)
    accessible = propagate_channel(seeds, mask)
    pocket = mask & ~accessible
    if return_faces:
        return mask, accessible, pocket, face_label_pairs(open_labels)
    return mask, accessible, pocket


def face_label_pairs(open_labels):
    """Wrap-edge label pairs of an open (aperiodic) component labeling:
    i32[2, n_face] where column j is (label at the LAST slice, label at
    the FIRST slice) of one periodic face position, concatenated over
    the three axes in order. Together with ``face_axis_ids`` this is
    the entire quotient graph of the periodic void network — every
    inter-component edge crosses a face — so the host-side
    displacement-vector analysis needs nothing else from the grid."""
    a_parts, b_parts = [], []
    for axis in range(3):
        sl_last = [slice(None)] * 3
        sl_last[axis] = -1
        sl_first = [slice(None)] * 3
        sl_first[axis] = 0
        a_parts.append(open_labels[tuple(sl_last)].reshape(-1))
        b_parts.append(open_labels[tuple(sl_first)].reshape(-1))
    return jnp.stack(
        [jnp.concatenate(a_parts), jnp.concatenate(b_parts)]
    )


def face_axis_ids(grid) -> np.ndarray:
    """Axis id (0/1/2) of each ``face_label_pairs`` column."""
    gx, gy, gz = grid
    return np.repeat(np.arange(3), [gy * gz, gx * gz, gx * gy])


@functools.partial(jax.jit, static_argnames=("steps",))
def dilate(mask, steps: int):
    """Periodic 6-neighbor dilation (octahedral structuring element)."""
    out = mask
    for _ in range(steps):
        grown = out
        for axis in range(3):
            for shift in (1, -1):
                grown = grown | jnp.roll(out, shift, axis=axis)
        out = grown
    return out


def fibonacci_sphere(n: int) -> np.ndarray:
    """n quasi-uniform unit vectors (deterministic surface sampling —
    replaces Zeo++'s per-atom MC surface sampling)."""
    i = np.arange(n) + 0.5
    phi = np.pi * (1 + 5**0.5) * i
    cos_t = 1 - 2 * i / n
    sin_t = np.sqrt(np.maximum(0, 1 - cos_t**2))
    return np.stack(
        [sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], axis=-1
    ).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("grid", "chunk"))
def surface_point_classification(
    frac_atoms,  # f32[N, 3]
    cell,  # f32[3, 3]
    radii,  # f32[N] (-1e9 for padding rows)
    r_probe,
    dirs,  # f32[K, 3] unit vectors (Fibonacci sphere)
    accessible,  # bool[Gx, Gy, Gz]
    pocket,  # bool[Gx, Gy, Gz]
    grid,
    chunk: int = 32,
):
    """Per-atom accessible / non-accessible surface-point counts.

    For each atom i, sample K points on the sphere of radius R_i+r_probe;
    a point is on the (probe-center) surface iff it lies outside every
    other atom's R_j+r_probe sphere (Zeo++'s ASA construction, sampled
    deterministically instead of by MC). Surface points are classified
    accessible/non-accessible by the void voxel they (or their outward
    nudge) fall into.

    Returns:
        (acc_counts i32[N], nacc_counts i32[N])
    """
    gx, gy, gz = grid
    n = frac_atoms.shape[0]
    k = dirs.shape[0]
    inv_cell = jnp.linalg.inv(cell)
    gvec = jnp.array([gx, gy, gz])

    pad = (-n) % chunk
    if pad:
        frac_atoms = jnp.concatenate(
            [frac_atoms, jnp.zeros((pad, 3), frac_atoms.dtype)]
        )
        radii = jnp.concatenate([radii, jnp.full((pad,), -1e9, radii.dtype)])
    n_pad = n + pad

    def lookup(field, frac_pts):
        f = frac_pts - jnp.floor(frac_pts)
        idx = jnp.minimum((f * gvec).astype(jnp.int32), gvec - 1)
        return field[idx[..., 0], idx[..., 1], idx[..., 2]]

    def chunk_counts(i0):
        fa = jax.lax.dynamic_slice(frac_atoms, (i0, 0), (chunk, 3))
        ra = jax.lax.dynamic_slice(radii, (i0,), (chunk,))
        centers = matvec3(fa, cell)  # [C, 3]
        pts = centers[:, None, :] + (ra[:, None, None] + r_probe) * dirs[None]
        # distance from each point to every atom surface (excluding self)
        fp = matvec3(pts, inv_cell)  # [C, K, 3] fractional
        df = fp[:, :, None, :] - frac_atoms[None, None, :, :]
        df = df - jnp.floor(df + 0.5)
        dc = matvec3(df, cell)
        d = jnp.sqrt(jnp.sum(dc * dc, axis=-1)) - (radii[None, None, :] + r_probe)
        gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (chunk, k, n_pad), 0)
        gj = jax.lax.broadcasted_iota(jnp.int32, (chunk, k, n_pad), 2)
        d = jnp.where((gi == gj) | (radii[None, None, :] < -1e8), jnp.inf, d)
        valid = (jnp.min(d, axis=-1) > -1e-4) & (ra[:, None] > -1e8)

        # classify by the voxel of the point and of a small outward nudge
        nudge = fp + matvec3(dirs[None] * 0.2, inv_cell)
        acc = lookup(accessible, fp) | lookup(accessible, nudge)
        poc = lookup(pocket, fp) | lookup(pocket, nudge)
        acc_pt = valid & acc
        nacc_pt = valid & ~acc & poc
        return (
            jnp.sum(acc_pt, axis=1).astype(jnp.int32),
            jnp.sum(nacc_pt, axis=1).astype(jnp.int32),
        )

    starts = jnp.arange(0, n_pad, chunk)
    acc, nacc = jax.lax.map(chunk_counts, starts)
    return acc.reshape(-1)[:n], nacc.reshape(-1)[:n]


@functools.partial(
    jax.jit, static_argnames=("grid", "chunk", "window")
)
def surface_point_classification_windowed(
    frac_atoms,  # f32[N, 3], NO padding rows
    cell,
    radii,  # f32[N]
    r_probe,
    dirs,
    accessible,
    pocket,
    grid,
    window: int = 1536,
    chunk: int = 32,
):
    """Sorted-window variant of ``surface_point_classification``.

    A sample point on atom i's probe sphere can only be blocked by atoms
    within R_i + R_j + 2*r_probe of the center (triangle inequality), so
    after sorting atoms by fractional x each chunk of centers tests a
    [chunk + 2*window] slice of sorted order instead of all N atoms. A
    vectorized binary search verifies per center that every atom within
    the worst-case fractional-x reach sits within ``window`` sorted
    positions (O(N log N); this used to be an O(N^2) recount), flagging
    any miss.

    Returns (acc_counts, nacc_counts, orig_idx, sorted_radii, missed):
    counts are in sorted order; scatter them back with
    ``out[orig_idx] = counts`` (orig_idx is -1 for internal padding
    rows), or weight them directly with ``sorted_radii`` (same order as
    the counts) when the per-atom identity is not needed.
    """
    gx, gy, gz = grid
    n = frac_atoms.shape[0]
    k = dirs.shape[0]
    assert chunk + 2 * window < n, "window too wide; use the full variant"
    inv_cell = jnp.linalg.inv(cell)
    gvec = jnp.array([gx, gy, gz])
    width = chunk + 2 * window

    fx = frac_atoms[:, 0] - jnp.floor(frac_atoms[:, 0])
    gidx = jnp.arange(n, dtype=jnp.int32)
    keys_s, ax, ay, az, rs, gis = jax.lax.sort(
        (fx, frac_atoms[:, 0], frac_atoms[:, 1], frac_atoms[:, 2], radii,
         gidx),
        dimension=0, num_keys=1,
    )
    fa_s = jnp.stack([ax, ay, az], axis=-1)

    # positional-window coverage check (exact; see the docstring)
    w0x = jnp.abs(jnp.linalg.det(cell)) / jnp.linalg.norm(
        jnp.cross(cell[1], cell[2])
    )
    rxa = (rs + jnp.max(radii) + 2.0 * r_probe) / w0x + 1e-6  # per center
    p_idx = jnp.arange(n, dtype=jnp.int32)
    x_hi = keys_s + rxa
    x_lo = keys_s - rxa
    span_r = jnp.where(
        x_hi < 1.0,
        jnp.searchsorted(keys_s, x_hi) - 1 - p_idx,
        (n - p_idx) + jnp.searchsorted(keys_s, x_hi - 1.0) - 1,
    )
    span_l = jnp.where(
        x_lo >= 0.0,
        p_idx - jnp.searchsorted(keys_s, x_lo),
        p_idx + (n - jnp.searchsorted(keys_s, x_lo + 1.0)),
    )
    missed = jnp.any((span_r > window) | (span_l > window))
    pad = (-n) % chunk
    if pad:
        fa_s = jnp.concatenate([fa_s, jnp.zeros((pad, 3), fa_s.dtype)])
        rs = jnp.concatenate([rs, jnp.full((pad,), -1e9, rs.dtype)])
        gis = jnp.concatenate([gis, jnp.full((pad,), -1, gis.dtype)])
    n_pad = n + pad

    def ext(a):
        return jnp.concatenate([a[n - window:n], a[:n], a[:window]])
    ext_f = jnp.stack([ext(ax), ext(ay), ext(az)], axis=-1)  # [n+2W, 3]
    ext_r = ext(rs[:n])

    def lookup(field, frac_pts):
        f = frac_pts - jnp.floor(frac_pts)
        idx = jnp.minimum((f * gvec).astype(jnp.int32), gvec - 1)
        return field[idx[..., 0], idx[..., 1], idx[..., 2]]

    def chunk_counts(c0):
        fa = jax.lax.dynamic_slice(fa_s, (c0, 0), (chunk, 3))
        ra = jax.lax.dynamic_slice(rs, (c0,), (chunk,))
        wf = jax.lax.dynamic_slice(ext_f, (c0, 0), (width, 3))
        wr = jax.lax.dynamic_slice(ext_r, (c0,), (width,))
        col = jax.lax.broadcasted_iota(jnp.int32, (chunk, width), 1)
        self_col = window + jax.lax.broadcasted_iota(
            jnp.int32, (chunk, width), 0
        )

        centers = matvec3(fa, cell)
        pts = centers[:, None, :] + (ra[:, None, None] + r_probe) * dirs[None]
        fp = matvec3(pts, inv_cell)  # [C, K, 3]
        df = fp[:, :, None, :] - wf[None, None, :, :]
        df = df - jnp.floor(df + 0.5)
        dc = matvec3(df, cell)
        d = jnp.sqrt(jnp.sum(dc * dc, axis=-1)) - (wr[None, None, :] + r_probe)
        d = jnp.where(
            (col[:, None, :] == self_col[:, None, :])
            | (wr[None, None, :] < -1e8),
            jnp.inf, d,
        )
        valid = (jnp.min(d, axis=-1) > -1e-4) & (ra[:, None] > -1e8)

        nudge = fp + matvec3(dirs[None] * 0.2, inv_cell)
        acc = lookup(accessible, fp) | lookup(accessible, nudge)
        poc = lookup(pocket, fp) | lookup(pocket, nudge)
        acc_pt = valid & acc
        nacc_pt = valid & ~acc & poc
        return (
            jnp.sum(acc_pt, axis=1).astype(jnp.int32),
            jnp.sum(nacc_pt, axis=1).astype(jnp.int32),
        )

    starts = jnp.arange(0, n_pad, chunk)
    acc, nacc = jax.lax.map(chunk_counts, starts)
    return acc.reshape(-1), nacc.reshape(-1), gis, rs[:n], missed


def _voxel_offset_norms(cell, grid):
    """|cartesian displacement| of every voxel-index offset, wrapped so
    offset 0 sits at index (0,0,0) — the circular-convolution layout."""
    gx, gy, gz = grid
    offs = []
    for g in (gx, gy, gz):
        i = jnp.arange(g)
        offs.append(((i + g // 2) % g - g // 2).astype(jnp.float32) / g)
    off_frac = jnp.stack(jnp.meshgrid(*offs, indexing="ij"), axis=-1)
    off_cart = matvec3(off_frac, cell)
    return jnp.sqrt(jnp.sum(off_cart * off_cart, axis=-1))


@functools.partial(jax.jit, static_argnames=("grid",))
def covering_volume_counts(dist, centers_ok, target, cell, levels, grid):
    """Covering-sphere (Gelb–Gubbins) pore-volume counts per radius level.

    For each radius ``t`` in ``levels``, counts the ``target`` voxels
    that lie inside some sphere of radius ``t`` centered at a voxel
    ``u`` with ``dist[u] >= t`` and ``centers_ok[u]`` — i.e. the volume
    whose pore radius (radius of the largest included sphere covering
    the point) is >= t. Differencing consecutive levels yields the
    pore-size distribution Zeo++'s -psd samples by Monte Carlo
    (amof/pore/pysimmzeopp.py:76); here the periodic spherical dilation
    is computed deterministically by FFT circular convolution, which is
    exact at voxel-center resolution and runs on the device as batched
    3-D FFTs instead of serial MC.

    Returns i32[len(levels)] counts (monotone non-increasing).
    """
    off_norm = _voxel_offset_norms(cell, grid)
    n_vox = grid[0] * grid[1] * grid[2]

    def per_level(t):
        mask = ((dist >= t) & centers_ok).astype(jnp.float32)
        kern = (off_norm <= t).astype(jnp.float32)
        # The convolution is integer-valued, so any threshold with
        # roundoff < 0.5 is exact. The f32 FFT error is dominated by
        # the DC (mean) product — ~eps * sum(mask) * sum(kern)/n, which
        # approaches 0.5 at production grids (~220^3, mask sums ~1e6).
        # Convolving the zero-mean fluctuation and adding the DC term
        # back in closed form removes that dominant error term; the
        # residual scales with the fluctuation energy, orders of
        # magnitude smaller for the near-full/near-empty masks where
        # the DC error was dangerous.
        m_sum = jnp.sum(mask)
        k_sum = jnp.sum(kern)
        m_mean = m_sum / n_vox
        conv = jnp.fft.irfftn(
            jnp.fft.rfftn(mask - m_mean) * jnp.fft.rfftn(kern), s=grid
        ) + m_mean * k_sum
        return jnp.sum((conv > 0.5) & target).astype(jnp.int32)

    return jax.lax.map(per_level, jnp.asarray(levels, jnp.float32))


@functools.partial(jax.jit, static_argnames=("grid", "n_steps"))
def ray_chord_lengths(
    dist, frac_points, dirs, cell, r_probe, grid, n_steps: int = 96,
    max_len: float = 50.0,
):
    """Chord lengths of rays through the probe-fit void (Zeo++
    -ray_atom, amof/pore/pysimmzeopp.py:133-134).

    From each start point (fractional, inside the void) a ray is traced
    along +dir and -dir by sphere marching on the distance field: each
    step advances by the field value minus the probe radius (a safe
    step — no atom surface can be closer), until the remaining
    clearance drops below half a voxel diagonal. The chord is the
    forward+backward travel; accuracy is grid-resolution bounded. Each
    direction is capped at ``max_len`` (open channels have unbounded
    chords; Zeo++'s own histogram tops out at 100 Å).

    Returns f32[M] chord lengths.
    """
    gx, gy, gz = grid
    gvec = jnp.array([gx, gy, gz])
    inv_cell = jnp.linalg.inv(cell)
    # conservative lookup slack: half the voxel diagonal
    voxel_diag = jnp.sqrt(jnp.sum(matvec3(1.0 / gvec[None].astype(
        jnp.float32), cell) ** 2))
    slack = 0.5 * voxel_diag

    def lookup(frac_pts):
        f = frac_pts - jnp.floor(frac_pts)
        idx = jnp.minimum((f * gvec).astype(jnp.int32), gvec - 1)
        return dist[idx[..., 0], idx[..., 1], idx[..., 2]]

    start_cart = matvec3(frac_points, cell)

    def march(sign):
        def body(_, state):
            s, alive = state
            p = start_cart + (sign * s)[:, None] * dirs
            clearance = lookup(matvec3(p, inv_cell)) - r_probe
            step = jnp.maximum(clearance - slack, 0.0)
            alive = alive & (clearance > slack) & (s < max_len)
            s = s + jnp.where(alive, jnp.maximum(step, 0.25 * slack), 0.0)
            return jnp.minimum(s, max_len), alive

        s0 = jnp.zeros(frac_points.shape[0], jnp.float32)
        alive0 = jnp.ones(frac_points.shape[0], bool)
        s, _ = jax.lax.fori_loop(0, n_steps, body, (s0, alive0))
        return s

    return march(1.0) + march(-1.0)


def _propagate_fixpoint(init, periodic: bool, sweeps: int):
    """Run masked max-propagation to fixpoint (labels carry walls as -1).

    Each round applies ``sweeps`` 6-neighbor roll/max sweeps, which XLA
    fuses, then checks for change."""
    mask = init >= 0

    def cond(state):
        return state[1]

    def body(state):
        labels, _ = state
        new = labels
        for _ in range(sweeps):
            new = _neighbor_max(new, mask, periodic)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.array(True)))
    return labels


@functools.partial(
    jax.jit, static_argnames=("dmax", "dxa", "chunk", "window")
)
def point_distance_windowed(
    frac_atoms,  # f32[N, 3], no padding rows
    cell,
    radii,  # f32[N]
    pts,  # f32[M, 3] fractional sample points, SORTED by pts[:, 0]
    pts_x_lo,  # f32[M/chunk] per-chunk min fractional x (static data)
    pts_x_hi,  # f32[M/chunk] per-chunk max fractional x
    dmax: float,
    dxa: float,
    chunk: int = 1024,
    window: int = 1536,
):
    """Clamped min distance-to-atom-surface at arbitrary sample points.

    The Monte-Carlo analog of ``distance_grid_windowed``: points are
    pre-sorted by fractional x (done once — the same sample set serves
    every frame), atoms are sorted per frame, and each point chunk
    tests only a ``window`` of atom sorted order. Misses are counted
    exactly and flagged. Used for the Zeo++-faithful -vol MC estimate
    (amof/pore/pysimmzeopp.py:127-128: AV from ``num_samples`` MC
    probes) with the connectivity grid kept coarse.

    Returns (f32[M] distances clamped at dmax, missed bool[]).
    """
    n = frac_atoms.shape[0]
    m = pts.shape[0]
    assert m % chunk == 0, "sample count must divide into chunks"

    fx = frac_atoms[:, 0] - jnp.floor(frac_atoms[:, 0])
    xs, ax, ay, az, rs = jax.lax.sort(
        (fx, frac_atoms[:, 0], frac_atoms[:, 1], frac_atoms[:, 2], radii),
        dimension=0, num_keys=1,
    )
    if window >= n:
        # no window exists: brute-force all atoms per chunk
        def chunk_min_full(c0):
            p = jax.lax.dynamic_slice(pts, (c0, 0), (chunk, 3))
            df = p[:, None, :] - frac_atoms[None, :, :]
            df = df - jnp.floor(df + 0.5)
            dc = matvec3(df, cell)
            d = jnp.sqrt(jnp.sum(dc * dc, axis=-1)) - radii[None, :]
            return jnp.minimum(jnp.min(d, axis=1), dmax)

        starts = jnp.arange(0, m, chunk)
        return (
            jax.lax.map(chunk_min_full, starts).reshape(-1),
            jnp.zeros((), bool),
        )

    ext = lambda a: jnp.concatenate([a, a])
    ext_x, ext_y, ext_z, ext_r = ext(ax), ext(ay), ext(az), ext(rs)

    lo = pts_x_lo - dxa
    hi = pts_x_hi + dxa
    s_idx = jnp.searchsorted(xs, lo % 1.0)
    e_idx = jnp.searchsorted(xs, hi % 1.0)
    cnt = jnp.where(hi % 1.0 >= lo % 1.0, e_idx - s_idx, e_idx + (n - s_idx))
    missed = jnp.any((cnt > window) | (hi - lo >= 1.0))

    def chunk_min(args):
        c0, s = args
        p = jax.lax.dynamic_slice(pts, (c0, 0), (chunk, 3))
        wx = jax.lax.dynamic_slice(ext_x, (s,), (window,))
        wy = jax.lax.dynamic_slice(ext_y, (s,), (window,))
        wz = jax.lax.dynamic_slice(ext_z, (s,), (window,))
        wr = jax.lax.dynamic_slice(ext_r, (s,), (window,))
        wf = jnp.stack([wx, wy, wz], axis=-1)
        df = p[:, None, :] - wf[None, :, :]
        df = df - jnp.floor(df + 0.5)
        dc = matvec3(df, cell)
        d = jnp.sqrt(jnp.sum(dc * dc, axis=-1)) - wr[None, :]
        return jnp.minimum(jnp.min(d, axis=1), dmax)

    starts = jnp.arange(0, m, chunk)
    d = jax.lax.map(chunk_min, (starts, s_idx)).reshape(-1)
    return d, missed


def grid_lookup(field, frac_pts, grid):
    """Nearest-voxel lookup of a grid field at fractional points."""
    gvec = jnp.array(grid)
    f = frac_pts - jnp.floor(frac_pts)
    idx = jnp.minimum((f * gvec).astype(jnp.int32), gvec - 1)
    return field[idx[..., 0], idx[..., 1], idx[..., 2]]


# --------------------------------------------------------------------------
# Sorted xy-columns: full-z tile passes for the -sa/-vol hot path
# --------------------------------------------------------------------------
#
# Atoms are bucketed into (nbx, nby) fractional-xy columns sized to the
# interaction reach and sorted by a column-major key; atoms of the two
# y-edge column rows are duplicated one row beyond each edge so every
# 3x3-column neighborhood is THREE CONTIGUOUS RUNS of sorted order (one
# per x row). A tile is one xy column of voxels over the FULL z extent,
# so each tile issues only three large dynamic slices instead of
# thousands of small ones. The z axis is handled per pair with a single
# fractional round (x/y need none after the per-tile unwrap), and all
# threshold tests compare squared distances — no per-pair sqrt.


def _sort_atoms_xycols(frac_atoms, extra, nbx: int, nby: int):
    """Sort atoms by xy-column with y-edge duplication.

    Column key space is ``bx * (nby + 2) + (by + 1)``: atoms of row
    by == nby-1 are duplicated at shifted index 0 and atoms of by == 0
    at shifted index nby+1, so any [by-1, by+1] query inside an x row
    is one contiguous run — no y-wrap cases.

    Args:
        frac_atoms: f32[N, 3].
        extra: list of f32[N] payload columns (radii, indices, ...).

    Returns (keys f32[M], payload f32[3 + len(extra), M]) with
    M = N + (edge-row duplicates); payload rows are (fx, fy, fz,
    *extra) — duplicates keep their ORIGINAL coordinates (the per-tile
    unwrap shifts them by the right lattice vector automatically).
    """
    fx = frac_atoms[:, 0] - jnp.floor(frac_atoms[:, 0])
    fy = frac_atoms[:, 1] - jnp.floor(frac_atoms[:, 1])
    fz = frac_atoms[:, 2] - jnp.floor(frac_atoms[:, 2])
    bx = jnp.minimum((fx * nbx).astype(jnp.int32), nbx - 1)
    by = jnp.minimum((fy * nby).astype(jnp.int32), nby - 1)
    stride = nby + 2
    key0 = (bx * stride + by + 1).astype(jnp.float32) + fz
    # duplicates: by == nby-1 -> shifted 0; by == 0 -> shifted nby+1
    key_lo = jnp.where(
        by == nby - 1, (bx * stride).astype(jnp.float32) + fz, 3e9
    )
    key_hi = jnp.where(
        by == 0, (bx * stride + nby + 1).astype(jnp.float32) + fz, 3e9
    )
    cols = [fx, fy, fz] + list(extra)
    keys = jnp.concatenate([key0, key_lo, key_hi])
    payload = [jnp.concatenate([c, c, c]) for c in cols]
    out = jax.lax.sort((keys, *payload), dimension=0, num_keys=1)
    return out[0], jnp.stack(out[1:], axis=0)


def xycol_plan(cells, radii_max, dmax, grid_raw, n_atoms):
    """Static plan for the xy-column mask kernel.

    Returns dict(grid, nbx, nby, window) or None when the cell is too
    small for >= 4x4 reach-wide columns. Grid x/y dims are rounded so
    columns tile them exactly (z only to gz % 4 == 0).
    """
    cells = np.asarray(cells, np.float64)
    if cells.ndim == 2:
        cells = cells[None]
    widths = []
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3
        cr = np.cross(cells[:, b], cells[:, c])
        v = np.abs(np.einsum("fi,fi->f", cells[:, a], cr))
        widths.append(float((v / np.linalg.norm(cr, axis=1)).min()))
    reach = float(dmax + radii_max)
    nbx = int(widths[0] / reach)
    nby = int(widths[1] / reach)
    if nbx < 4 or nby < 4:
        return None

    def round_axis(g_raw, nb_max):
        """(g, nb): smallest g >= g_raw with g = nb * tv, nb <= nb_max,
        and g % 8 == 0, so the grid splits into 8-row slabs (the shape
        a slab-blocked flood-fill kernel would take)."""
        best = None
        for nb in range(nb_max, 3, -1):
            tv = -(-g_raw // nb)
            for bump in range(8):
                g = nb * (tv + bump)
                if g % 8 == 0:
                    if best is None or g < best[0]:
                        best = (g, nb)
                    break
        if best is None:  # fall back to even dims
            nb = nb_max
            tv = -(-g_raw // nb)
            tv += tv % 2
            return nb * tv, nb
        return best

    gx, nbx = round_axis(grid_raw[0], nbx)
    gy, nby = round_axis(grid_raw[1], nby)
    gz = -(-grid_raw[2] // 4) * 4
    # slice cap: 3 contiguous columns (plus y-edge duplicates)
    mean3 = 3.0 * n_atoms / (nbx * nby) * (1.0 + 2.0 / nby)
    # additive tail margin only: a multiplicative factor on top of the
    # Poisson term double-counts and inflated candidate work ~15-25%
    w_est = mean3 + 6.0 * np.sqrt(max(mean3, 1.0)) + 16
    window = int(-(-w_est // 8) * 8)
    if 3 * window >= n_atoms:
        return None

    def pad8(lam):
        return int(-((lam + 6.0 * np.sqrt(max(lam, 1.0)) + 16) // -8) * 8)

    # z-chunked candidate windows: a voxel at fractional z v only needs
    # candidates with min-imaged |fz - v| <= reach / h_z (h_z = the
    # cell's perpendicular z width), so each z chunk of the full-z tile
    # can test a z-sorted sub-window of the runs instead of all 3*window
    # candidates — the remaining candidate-reduction axis after x/y
    # columns. Requires zmargin < 1/n_zc so only the first/last chunk
    # needs a wrap slice.
    #
    # Not the production path: pore/batch.py does not pass the z
    # fields, because the ~2.2x candidate cut costs ~30 small
    # dynamic-slice segments per tile instead of 3 fat full-run ops.
    # The kernel path stays bit-exact-tested; its GPU cost is not
    # measured.
    zmargin = reach / widths[2]
    n_zc = max(
        (d for d in range(2, 9) if gz % d == 0 and d * zmargin < 1.0),
        default=0,
    )
    wz = wzw = 0
    if n_zc:
        wz = pad8(mean3 * (1.0 / n_zc + 2.0 * zmargin))
        wzw = pad8(mean3 * zmargin)
        # enable only when the windowed sweep clearly beats the full
        # runs (middle chunks cost wz, the two edge chunks wz + wzw)
        if wz >= window or wz + wzw / n_zc > 0.8 * window:
            n_zc = 0
    return {"grid": (gx, gy, gz), "nbx": nbx, "nby": nby,
            "window": window, "n_zc": n_zc, "wz": wz, "wzw": wzw,
            "zmargin": float(zmargin) if n_zc else 0.0}


def calibrate_z_windows(positions, cells, plan, max_frames: int = 4):
    """Data-aware z-window capacities for ``void_masks_columns``.

    The Poisson estimate in ``xycol_plan`` under-sizes ``wz``/``wzw``
    on layered structures (crystals repeat atom planes along z, so a
    narrow z window can hold several times the uniform-density count,
    and every miss costs a widened-retry recompute). Mirrors the BAD
    idea of data-aware capacities: replicate the sorted
    layout on the host for a few sampled frames, measure the actual
    worst (run, chunk) window populations, and pad. The exact on-device
    ``missed`` flag still guards the unsampled frames.

    Mutates and returns ``plan`` (sets wz/wzw, or n_zc=0 when the
    measured windows erase the benefit).
    """
    if not plan.get("n_zc"):
        return plan
    positions = np.asarray(positions, np.float64)
    if positions.ndim == 2:
        positions = positions[None]
    cells = np.asarray(cells, np.float64)
    if cells.ndim == 2:
        cells = cells[None]
    nbx, nby, window = plan["nbx"], plan["nby"], plan["window"]
    n_zc, m = plan["n_zc"], plan["zmargin"]
    stride = nby + 2
    zlo = np.arange(n_zc) / n_zc - m
    zhi = (np.arange(n_zc) + 1) / n_zc + m
    idx = np.unique(
        np.linspace(0, len(positions) - 1, max_frames).astype(int)
    )
    max_wz = max_wzw = 0
    t_ids = np.arange(nbx * nby)
    c0 = (
        (((t_ids // nby)[:, None] + np.array([-1, 0, 1])[None, :]) % nbx)
        * stride + (t_ids % nby)[:, None]
    ).reshape(-1)  # [n_tiles*3]
    for f in idx:
        frac = positions[f] @ np.linalg.inv(
            cells[min(f, len(cells) - 1)]
        )
        frac -= np.floor(frac)
        fx, fy, fz = frac.T.astype(np.float32)
        bx = np.minimum((fx * nbx).astype(np.int64), nbx - 1)
        by = np.minimum((fy * nby).astype(np.int64), nby - 1)
        key0 = (bx * stride + by + 1).astype(np.float32) + fz
        key_lo = np.where(by == nby - 1, (bx * stride) + fz, 3e9)
        key_hi = np.where(by == 0, (bx * stride + nby + 1) + fz, 3e9)
        keys = np.concatenate([key0, key_lo, key_hi])
        fz_all = np.concatenate([fz, fz, fz])
        order = np.argsort(keys, kind="stable")
        keys_s = keys[order]
        fz_s = fz_all[order]
        cstarts = np.searchsorted(
            keys_s, np.arange(nbx * stride + 1, dtype=np.float32)
        )
        starts = np.minimum(cstarts[c0], len(keys_s) - window)
        runs = np.sort(
            fz_s[starts[:, None] + np.arange(window)[None, :]], axis=1
        )  # [n_tiles*3, W]
        lo_i = np.stack([
            np.searchsorted(r, zlo, side="left") for r in runs
        ])
        hi_i = np.stack([
            np.searchsorted(r, zhi, side="right") for r in runs
        ])
        max_wz = max(max_wz, int((hi_i - lo_i).max()))
        top = window - np.stack([
            np.searchsorted(r, 1.0 - m, side="left") for r in runs
        ])
        bot = np.stack([
            np.searchsorted(r, m, side="right") for r in runs
        ])
        max_wzw = max(max_wzw, int(top.max()), int(bot.max()))
    plan["wz"] = int(-(-(max_wz * 1.15 + 8) // 8) * 8)
    plan["wzw"] = int(-(-(max_wzw * 1.15 + 8) // 8) * 8)
    if (plan["wz"] >= window
            or plan["wz"] + plan["wzw"] / n_zc > 0.8 * window):
        plan["n_zc"] = 0
        plan["zmargin"] = 0.0
    return plan


def assign_points_to_xytiles(pts, plan):
    """Host-side static assignment of sample points to xy-column tiles.

    Returns (pts_tiled f32[nbx*nby, P, 3], weights f32[nbx*nby, P]):
    P is the exact max tile occupancy; padding slots sit at the tile
    center with weight 0.
    """
    pts = np.asarray(pts, np.float32)
    nbx, nby = plan["nbx"], plan["nby"]
    ti = np.minimum((pts[:, 0] * nbx).astype(np.int64), nbx - 1)
    tj = np.minimum((pts[:, 1] * nby).astype(np.int64), nby - 1)
    tile = ti * nby + tj
    n_tiles = nbx * nby
    counts = np.bincount(tile, minlength=n_tiles)
    cap = int(counts.max())
    out = np.empty((n_tiles, cap, 3), np.float32)
    t_ids = np.arange(n_tiles)
    out[:, :, 0] = ((t_ids // nby) + 0.5)[:, None] / nbx
    out[:, :, 1] = ((t_ids % nby) + 0.5)[:, None] / nby
    out[:, :, 2] = 0.5
    w = np.zeros((n_tiles, cap), np.float32)
    order = np.argsort(tile, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for t in np.nonzero(counts)[0]:
        sel = order[starts[t]:starts[t + 1]]
        out[t, :counts[t]] = pts[sel]
        w[t, :counts[t]] = 1.0
    return out, w


@functools.partial(
    jax.jit,
    static_argnames=("grid", "probe", "chan", "nbx", "nby", "window",
                     "n_zc", "wz", "wzw", "zmargin"),
)
def void_masks_columns(
    frac_atoms,  # f32[N, 3], no padding rows
    cell,
    radii,  # f32[N]
    grid,
    probe: float,
    chan: float,
    nbx: int,
    nby: int,
    window: int,
    pts_tiled=None,  # f32[nbx*nby, P, 3] fractional sample points
    n_zc: int = 0,
    wz: int = 0,
    wzw: int = 0,
    zmargin: float = 0.0,
):
    """Probe-fit void masks via sorted xy-columns — the -sa/-vol hot
    path (reference semantics: amof/pore/pysimmzeopp.py:119-128; the
    masks are exactly ``distance_grid(...) >= probe/chan`` up to f32
    rounding of borderline voxels).

    Per tile (one xy voxel column, full z): three contiguous sorted
    runs cover the 3x3-column candidate neighborhood; candidates are
    unwrapped into the tile frame (x/y exact by one whole-lattice
    shift), the z axis minimum-imaged per pair with one fractional
    round, and every test compares squared distances against
    per-candidate (R_j + t)^2 — no per-pair sqrt. ``pts_tiled``
    optionally adds per-tile sample points (Zeo++ -vol MC probes)
    whose probe-fit flags ride the same candidate slices.

    Returns (mask_probe, mask_chan, fit_pts or None, missed); the
    missed flag (slice-capacity overflow, exact per-frame check) tells
    callers to fall back.
    """
    gx, gy, gz = grid
    assert gx % nbx == 0 and gy % nby == 0
    tvx, tvy = gx // nbx, gy // nby
    n_tiles = nbx * nby
    stride = nby + 2

    keys, payload = _sort_atoms_xycols(frac_atoms, [radii], nbx, nby)
    col_ids = jnp.arange(nbx * stride + 1, dtype=jnp.float32)
    cstarts = jnp.searchsorted(keys, col_ids)  # [nbx*stride + 1]

    t_ids = np.arange(n_tiles)
    t_i, t_j = t_ids // nby, t_ids % nby
    # per (tile, x-row) run start column (shifted-y space): row bx',
    # columns [tj, tj+3) -> shifted start index tj
    c0 = (
        ((t_i[:, None] + np.array([-1, 0, 1])[None, :]) % nbx) * stride
        + t_j[:, None]
    )  # [n_tiles, 3]
    starts = cstarts[jnp.asarray(c0.reshape(-1))].reshape(n_tiles, 3)
    ends = cstarts[jnp.asarray((c0 + 3).reshape(-1))].reshape(n_tiles, 3)
    missed = jnp.any((ends - starts) > window)
    starts = jnp.minimum(starts, keys.shape[0] - window).astype(jnp.int32)

    n_vox_tile = tvx * tvy * gz
    two_masks = probe != chan
    thr_hi = float(max(probe, chan))
    thr_lo = float(min(probe, chan))
    cell_z = cell[2]  # lattice vector for per-pair z wrapping

    def tile_candidates(tile):
        """Unwrapped candidates of one tile, one entry per sorted run
        (3 slices kept separate: concatenating them materializes
        [rows, 3W, 3] difference tensors; per-slice [rows, W] working
        sets stay small). Each entry is
        (cart [W, 3], fz [W], radius [W], frac_xy [2, W])."""
        ti = tile // nby
        tj = tile % nby
        center = jnp.stack([
            (ti.astype(jnp.float32) + 0.5) / nbx,
            (tj.astype(jnp.float32) + 0.5) / nby,
        ])
        st = starts[tile]
        out = []
        for s in range(3):
            cand = jax.lax.dynamic_slice(
                payload, (0, st[s]), (4, window)
            )
            cxy = cand[:2] - jnp.round(cand[:2] - center[:, None])
            cf = jnp.concatenate([cxy, cand[2:3]], axis=0)  # [3, W]
            out.append((matvec3(cf.T, cell), cf[2], cand[3], cxy))
        return out

    def masks_of(v, cand_slices):
        """Masks at fractional rows v [R, 3]: per-axis accumulation
        against each candidate slice (z minimum-imaged per pair), AND
        across slices — no [R, W, 3] tensor is ever formed. Used for
        irregular points (MC probes); voxels take the factorized
        subcolumn path below."""
        v_cart = matvec3(v, cell)
        m_hi = m_lo = None
        for c_cart, c_fz, wr, _ in cand_slices:
            dxc = v_cart[:, 0:1] - c_cart[None, :, 0]
            dyc = v_cart[:, 1:2] - c_cart[None, :, 1]
            dzc = v_cart[:, 2:3] - c_cart[None, :, 2]
            s = jnp.round(v[:, 2:3] - c_fz[None, :])
            dxc = dxc - s * cell_z[0]
            dyc = dyc - s * cell_z[1]
            dzc = dzc - s * cell_z[2]
            d2 = dxc * dxc + dyc * dyc + dzc * dzc  # [R, W]
            h = jnp.all(d2 >= ((wr + thr_hi) ** 2)[None, :], axis=1)
            m_hi = h if m_hi is None else (m_hi & h)
            if two_masks:
                lo = jnp.all(
                    d2 >= ((wr + thr_lo) ** 2)[None, :], axis=1
                )
                m_lo = lo if m_lo is None else (m_lo & lo)
        if not two_masks:
            m_lo = m_hi
        return m_hi, m_lo

    # voxel pass: a few tiles per map step, each tile's full voxel set
    # against its per-slice candidates — fat steps cut the per-step
    # loop overhead of ~2000 thin steps, while per-slice working sets
    # stay at a few MB.
    #
    # The per-voxel test is FACTORIZED over the z axis: for a voxel
    # subcolumn (fixed fractional x/y) and candidate c, the squared
    # distance as a function of the z-minimum-imaged fractional offset
    # u is the exact quadratic
    #     d2(u) = QQ + 2*QZ*u + a*u^2,
    #     q = dfx*cell_x + dfy*cell_y, QQ = |q|^2, QZ = q.cell_z,
    #     a = |cell_z|^2
    # (same arithmetic as the pairwise form, regrouped — valid for any
    # triclinic cell). QQ/QZ are hoisted per (subcolumn, candidate)
    # and amortized over the gz voxels of the subcolumn, so the
    # [subcols, gz, W] sweep costs ~4 ops per test instead of ~15
    # — a ~3x op cut on this compute-bound pass (points are
    # irregular, get no amortization, and keep masks_of).
    t_batch = next((b for b in (4, 3, 2, 1) if n_tiles % b == 0), 1)
    n_sub = tvx * tvy
    sub_ids = np.arange(n_sub)
    sub_lx = jnp.asarray((sub_ids // tvy).astype(np.float32))
    sub_ly = jnp.asarray((sub_ids % tvy).astype(np.float32))
    vz_all = (jnp.arange(gz, dtype=jnp.float32) + 0.5) / gz
    a_zz = jnp.sum(cell_z * cell_z)

    def tile_voxel_masks(ti, tj, cand_slices):
        sub_fx = ((ti * tvx).astype(jnp.float32) + sub_lx + 0.5) / gx
        sub_fy = ((tj * tvy).astype(jnp.float32) + sub_ly + 0.5) / gy
        m_hi = m_lo = None
        for _, c_fz, wr, c_fxy in cand_slices:
            dfx = sub_fx[:, None] - c_fxy[0][None, :]  # [S, W]
            dfy = sub_fy[:, None] - c_fxy[1][None, :]
            qx = dfx * cell[0, 0] + dfy * cell[1, 0]
            qy = dfx * cell[0, 1] + dfy * cell[1, 1]
            qz = dfx * cell[0, 2] + dfy * cell[1, 2]
            qq = qx * qx + qy * qy + qz * qz  # [S, W]
            qdz = (
                qx * cell_z[0] + qy * cell_z[1] + qz * cell_z[2]
            ) * 2.0
            dz = vz_all[:, None] - c_fz[None, :]  # [gz, W]
            u = dz - jnp.round(dz)
            uu = a_zz * (u * u)
            d2 = (
                qq[:, None, :] + uu[None, :, :]
                + u[None, :, :] * qdz[:, None, :]
            )  # [S, gz, W]
            h = jnp.all(
                d2 >= ((wr + thr_hi) ** 2)[None, None, :], axis=2
            )
            m_hi = h if m_hi is None else (m_hi & h)
            if two_masks:
                lo = jnp.all(
                    d2 >= ((wr + thr_lo) ** 2)[None, None, :], axis=2
                )
                m_lo = lo if m_lo is None else (m_lo & lo)
        if not two_masks:
            m_lo = m_hi
        # [S, gz] flattens to (lx*tvy + ly)*gz + k == the tile's
        # n_vox_tile row order
        return m_hi.reshape(-1), m_lo.reshape(-1)

    # z-chunked voxel pass (not the production path; see the note in
    # xycol_plan):
    # the full-z tile is split into n_zc chunks;
    # each chunk's voxels only need candidates whose min-imaged
    # fractional z offset is within zmargin = reach / h_z (d >= |u|*h_z
    # for any xy offset, h_z the cell's perpendicular z width), so the
    # runs are re-sorted by fz in-tile (one batched lax.sort pooling
    # the 3 y-columns per run for fat Poisson statistics) and each
    # chunk tests a dynamic [wz] sub-window instead of all `window`
    # candidates. Chunk 0 / n_zc-1 additionally test a static-position
    # edge slice ([W-wzw, W) / [0, wzw)) covering the periodic z wrap
    # (exactly the fz in [1-zmargin, 1) / [0, zmargin) candidates,
    # possible since zmargin < 1/n_zc). Extra candidates in any slice
    # are harmless (every candidate is a real atom under an exact
    # min-image test); capacity shortfalls raise `missed` exactly, so
    # callers fall back — identical contract to the xy windows.
    use_z = (n_zc >= 2 and 0 < wz <= window and 0 <= wzw <= window
             and zmargin * n_zc < 1.0 and gz % n_zc == 0)
    gzc = gz // n_zc if use_z else gz
    zlo_b = np.arange(n_zc) / max(n_zc, 1) - zmargin
    zhi_b = (np.arange(n_zc) + 1) / max(n_zc, 1) + zmargin

    def zwin_bounds(fz_s):
        """Per-run window starts/counts: ([n_zc] start, miss scalar)."""
        lo = jnp.searchsorted(
            fz_s, jnp.asarray(zlo_b, jnp.float32), side="left"
        ).astype(jnp.int32)
        hi = jnp.searchsorted(
            fz_s, jnp.asarray(zhi_b, jnp.float32), side="right"
        ).astype(jnp.int32)
        miss = jnp.any(hi - lo > wz)
        if zmargin > 0.0:
            top = window - jnp.searchsorted(
                fz_s, jnp.float32(1.0 - zmargin), side="left"
            )
            bot = jnp.searchsorted(
                fz_s, jnp.float32(zmargin), side="right"
            )
            miss = miss | (top > wzw) | (bot > wzw)
        start = jnp.clip(lo, 0, window - wz)
        return start, miss

    def tile_voxel_masks_z(ti, tj, cand_slices):
        sub_fx = ((ti * tvx).astype(jnp.float32) + sub_lx + 0.5) / gx
        sub_fy = ((tj * tvy).astype(jnp.float32) + sub_ly + 0.5) / gy
        fz3 = jnp.stack([c[1] for c in cand_slices])  # [3, W]
        fx3 = jnp.stack([c[3][0] for c in cand_slices])
        fy3 = jnp.stack([c[3][1] for c in cand_slices])
        wr3 = jnp.stack([c[2] for c in cand_slices])
        fz3, fx3, fy3, wr3 = jax.lax.sort(
            (fz3, fx3, fy3, wr3), dimension=1, num_keys=1
        )
        starts = []
        miss_t = jnp.asarray(False)
        for s in range(3):
            st, ms = zwin_bounds(fz3[s])
            starts.append(st)
            miss_t = miss_t | ms

        def seg_masks(st, width, s, vz):
            """One candidate segment of run ``s`` vs the chunk's
            voxels — same factorized quadratic as the full-run pass."""
            fzc = jax.lax.dynamic_slice(fz3[s], (st,), (width,))
            fxc = jax.lax.dynamic_slice(fx3[s], (st,), (width,))
            fyc = jax.lax.dynamic_slice(fy3[s], (st,), (width,))
            wrc = jax.lax.dynamic_slice(wr3[s], (st,), (width,))
            dfx = sub_fx[:, None] - fxc[None, :]  # [S, width]
            dfy = sub_fy[:, None] - fyc[None, :]
            qx = dfx * cell[0, 0] + dfy * cell[1, 0]
            qy = dfx * cell[0, 1] + dfy * cell[1, 1]
            qz = dfx * cell[0, 2] + dfy * cell[1, 2]
            qq = qx * qx + qy * qy + qz * qz
            qdz = (
                qx * cell_z[0] + qy * cell_z[1] + qz * cell_z[2]
            ) * 2.0
            dz = vz[:, None] - fzc[None, :]  # [gzc, width]
            u = dz - jnp.round(dz)
            uu = a_zz * (u * u)
            d2 = (
                qq[:, None, :] + uu[None, :, :]
                + u[None, :, :] * qdz[:, None, :]
            )  # [S, gzc, width]
            h = jnp.all(
                d2 >= ((wrc + thr_hi) ** 2)[None, None, :], axis=2
            )
            lo_m = None
            if two_masks:
                lo_m = jnp.all(
                    d2 >= ((wrc + thr_lo) ** 2)[None, None, :], axis=2
                )
            return h, lo_m

        mh_chunks, mlo_chunks = [], []
        for k in range(n_zc):
            vz = vz_all[k * gzc:(k + 1) * gzc]
            mh = ml = None
            for s in range(3):
                segs = [(starts[s][k], wz)]
                if zmargin > 0.0 and k == 0:
                    segs.append((window - wzw, wzw))
                if zmargin > 0.0 and k == n_zc - 1:
                    segs.append((0, wzw))
                for st, width in segs:
                    h, lo_m = seg_masks(st, width, s, vz)
                    mh = h if mh is None else (mh & h)
                    if two_masks:
                        ml = lo_m if ml is None else (ml & lo_m)
            mh_chunks.append(mh)
            mlo_chunks.append(ml if two_masks else mh)
        m_hi = jnp.concatenate(mh_chunks, axis=1)  # [S, gz]
        m_lo = jnp.concatenate(mlo_chunks, axis=1)
        return m_hi.reshape(-1), m_lo.reshape(-1), miss_t

    def tile_masks(tile, pts):
        ti = tile // nby
        tj = tile % nby
        cand_slices = tile_candidates(tile)
        if use_z:
            m_hi, m_lo, miss_t = tile_voxel_masks_z(ti, tj, cand_slices)
        else:
            m_hi, m_lo = tile_voxel_masks(ti, tj, cand_slices)
            miss_t = jnp.asarray(False)
        if pts is None:
            return m_hi, m_lo, miss_t
        p_hi, p_lo = masks_of(pts, cand_slices)
        return m_hi, m_lo, (p_hi if probe >= chan else p_lo), miss_t

    def tile_step(args):
        if pts_tiled is None:
            (t0,) = args
            outs = [tile_masks(t0 + t, None) for t in range(t_batch)]
        else:
            t0, pts_b = args
            outs = [
                tile_masks(t0 + t, pts_b[t]) for t in range(t_batch)
            ]
        return tuple(jnp.stack(o) for o in zip(*outs))

    t0s = jnp.arange(0, n_tiles, t_batch, dtype=jnp.int32)
    if pts_tiled is None:
        m_hi, m_lo, miss_z = jax.lax.map(tile_step, (t0s,))
        fit_pts = None
    else:
        m_hi, m_lo, fit_pts, miss_z = jax.lax.map(
            tile_step,
            (t0s, pts_tiled.reshape(-1, t_batch, *pts_tiled.shape[1:])),
        )
        fit_pts = fit_pts.reshape(n_tiles, -1)
    missed = missed | jnp.any(miss_z)
    m_hi = m_hi.reshape(n_tiles, n_vox_tile)
    m_lo = m_lo.reshape(n_tiles, n_vox_tile)

    def to_grid(m):
        g = m.reshape(nbx, nby, tvx, tvy, gz)
        return g.transpose(0, 2, 1, 3, 4).reshape(gx, gy, gz)

    if probe >= chan:
        m_probe_t, m_chan_t = m_hi, m_lo
    else:
        m_probe_t, m_chan_t = m_lo, m_hi
    return to_grid(m_probe_t), to_grid(m_chan_t), fit_pts, missed


def surface_plan(cells, radii_max, probe, n_atoms, chunk: int = 64):
    """Static plan for ``surface_valid_columns``: coarse xy columns
    wide enough for the blocker reach R_i + R_j + 2*probe.

    Returns dict(nbx, nby, window, chunk, col_cap) or None when the
    cell is too small for >= 3 coarse columns per axis.

    ``chunk`` trades map-step count against slot padding (col_cap
    rounds up to it); its best value on the GPU is not measured.
    """
    cells = np.asarray(cells, np.float64)
    if cells.ndim == 2:
        cells = cells[None]
    widths = []
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3
        cr = np.cross(cells[:, b], cells[:, c])
        v = np.abs(np.einsum("fi,fi->f", cells[:, a], cr))
        widths.append(float((v / np.linalg.norm(cr, axis=1)).min()))
    reach = float(2.0 * radii_max + 2.0 * probe)
    nbx = int(widths[0] / reach)
    nby = int(widths[1] / reach)
    if nbx < 3 or nby < 3:
        return None
    mean3 = 3.0 * n_atoms / (nbx * nby) * (1.0 + 2.0 / nby)
    # additive tail margin only: a multiplicative factor on top of the
    # Poisson term double-counts and inflated candidate work ~15-25%
    w_est = mean3 + 6.0 * np.sqrt(max(mean3, 1.0)) + 16
    window = int(-(-w_est // 8) * 8)
    if 3 * window >= n_atoms:
        return None
    col_mean = n_atoms / (nbx * nby)
    cap_est = col_mean + 5.5 * np.sqrt(max(col_mean, 1.0)) + 8
    col_cap = int(-(-cap_est // chunk) * chunk)
    return {"nbx": nbx, "nby": nby, "window": window, "chunk": chunk,
            "col_cap": col_cap}


def surface_candidate_mask(frac_atoms, inv_cell, radii, r_probe, dirs,
                           grid, cand_mask):
    """Exact per-atom candidate prefilter of ``surface_valid_columns``:
    an atom is a candidate iff ANY of its K sphere
    points lands on a voxel whose classification code can make the
    point count (or, within a sub-voxel margin of a voxel boundary, on
    the 3^3-dilated mask — absorbing last-ulp index disagreement with
    the in-chunk point computation).

    The sharp mask decides candidacy; the dilated mask is consulted
    ONLY near voxel boundaries (measured index-disagreement bound
    ~1.5e-4 voxel units; margin 5e-4). Dilating unconditionally
    inflated a 0.85%-sparse glass mask ~20x and destroyed the skip
    rate. Returns bool[N]; all-true when ``cand_mask`` is None.
    """
    n = frac_atoms.shape[0]
    if cand_mask is None:
        return jnp.ones((n,), bool)
    gvec = jnp.array(grid)
    fx = frac_atoms[:, 0] - jnp.floor(frac_atoms[:, 0])
    fy = frac_atoms[:, 1] - jnp.floor(frac_atoms[:, 1])
    fz = frac_atoms[:, 2] - jnp.floor(frac_atoms[:, 2])
    k = dirs.shape[0]
    md = cand_mask
    for ax in range(3):  # separable periodic 3^3 dilation
        md = md | jnp.roll(md, 1, ax) | jnp.roll(md, -1, ax)
    code = cand_mask.astype(jnp.int8) | (md.astype(jnp.int8) << 1)
    cflat = code.reshape(-1)
    fo = matvec3(dirs, inv_cell)  # [K, 3] frac offset per unit dir
    nshift = matvec3(dirs * jnp.float32(0.2), inv_cell)
    fbase = jnp.stack([fx, fy, fz], axis=1)
    fp_all = (
        fbase[:, None, :]
        + (radii[:, None, None] + r_probe) * fo[None]
    )  # [N, K, 3]

    def lin_bnd(f):
        f = f - jnp.floor(f)
        fg = f * gvec
        idx = jnp.minimum(fg.astype(jnp.int32), gvec - 1)
        lin = (
            idx[..., 0] * grid[1] + idx[..., 1]
        ) * grid[2] + idx[..., 2]
        near = jnp.any(
            jnp.abs(fg - jnp.round(fg)) < jnp.float32(5e-4), axis=-1
        )
        return lin, near

    l1, nb1 = lin_bnd(fp_all)
    l2, nb2 = lin_bnd(fp_all + nshift[None])
    c1 = cflat[l1.reshape(-1)].reshape(n, k)
    c2 = cflat[l2.reshape(-1)].reshape(n, k)
    cand_pt = (
        ((c1 & 1) | (c2 & 1)).astype(bool)
        | (nb1 & (c1 >= 2))
        | (nb2 & (c2 >= 2))
    )
    return cand_pt.any(axis=1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "grid", "nbx", "nby", "window", "chunk", "col_cap", "c_batch",
    ),
)
def surface_valid_columns(
    frac_atoms,  # f32[N, 3], no padding rows
    cell,
    radii,  # f32[N]
    r_probe,
    dirs,  # f32[K, 3] unit vectors
    grid,
    nbx: int,
    nby: int,
    window: int,
    chunk: int,
    col_cap: int,
    cand_mask=None,  # optional bool[gx, gy, gz]: voxels whose codes
    #                  can make a point count (accessible | pocket)
    c_batch: int = 8,  # chunk slots per map step (fat steps)
):
    """Per-point surface validity + voxel indices via coarse sorted
    xy-columns.

    The Zeo++ ASA construction (amof/pore/pysimmzeopp.py:119-125): for
    each atom i, K points on the sphere of radius R_i + r_probe; a
    point counts iff it lies outside every OTHER atom's inflated
    sphere. Blockers of atom i's points lie within R_i + R_j +
    2*r_probe of its center, so coarse columns of that width give
    every chunk of one column's atoms a 3-slice candidate set.

    Void classification is left to the caller: the kernel returns
    LINEAR voxel indices of each point and of its outward nudge, so
    the caller classifies with two big flat gathers instead of many
    small per-chunk gathers, each of which pays a fixed latency.

    Chunks are column-aligned slots (columns exceeding ``col_cap``
    raise the missed flag, as do 3-column runs over ``window``).

    ``cand_mask`` enables the EXACT candidate prefilter: a point can
    only ever count when its voxel (or its outward nudge's) carries a
    nonzero classification code, so atoms none of whose K points hit
    the mask (sharp test; near-voxel-boundary points fall back to the
    1-voxel-dilated mask, absorbing last-ulp index disagreement with
    the in-chunk point computation) cannot contribute — they sort to
    the BACK of their column and whole chunks without a candidate atom
    skip the blocker-window distance pass entirely via lax.cond (real
    branching: the per-frame loop is a sequential lax.map). In a dense
    glass < 1% of points are near void, so most chunks skip; results
    are bit-identical to the unfiltered pass.

    Returns (valid bool[S, K], idx_pt i32[S, K], idx_nudge i32[S, K],
    orig_idx i32[S], radii f32[S], missed bool[]) in slot order,
    S = (n_cols * ceil(col_cap/chunk), rounded up to a multiple of
    the step batch) * chunk; padding slots carry orig_idx -1 and
    valid False.
    """
    n = frac_atoms.shape[0]
    inv_cell = jnp.linalg.inv(cell)
    n_cols = nbx * nby
    stride = nby + 2
    gvec = jnp.array(grid)
    cell_z = cell[2]

    fx = frac_atoms[:, 0] - jnp.floor(frac_atoms[:, 0])
    fy = frac_atoms[:, 1] - jnp.floor(frac_atoms[:, 1])
    fz = frac_atoms[:, 2] - jnp.floor(frac_atoms[:, 2])
    bx = jnp.minimum((fx * nbx).astype(jnp.int32), nbx - 1)
    by = jnp.minimum((fy * nby).astype(jnp.int32), nby - 1)
    gidx = jnp.arange(n, dtype=jnp.float32)

    k = dirs.shape[0]
    cand = surface_candidate_mask(
        frac_atoms, inv_cell, radii, r_probe, dirs, grid, cand_mask
    )

    # centers: originals only, sorted by column id with candidate atoms
    # FIRST within each column (chunks past a column's candidate prefix
    # skip the blocker pass; z-order within a column is irrelevant —
    # windows are per column, not per z)
    key_c = (bx * nby + by).astype(jnp.float32) + jnp.where(
        cand, fz * 0.5, 0.5 + fz * 0.5
    )
    keys_c, cx, cy, cz, cr, cg, ccand = jax.lax.sort(
        (key_c, fx, fy, fz, radii, gidx, cand.astype(jnp.float32)),
        dimension=0, num_keys=1,
    )
    centers_pl = jnp.stack([cx, cy, cz, cr, cg, ccand], axis=0)  # [6, N]
    c_bounds = jnp.searchsorted(
        keys_c, jnp.arange(n_cols + 1, dtype=jnp.float32)
    )
    c_counts = c_bounds[1:] - c_bounds[:-1]
    missed = jnp.any(c_counts > col_cap)

    # blockers: y-edge-duplicated column sort (3 contiguous runs per
    # 3x3 neighborhood), with original indices for self-exclusion
    keys_b, blockers_pl = _sort_atoms_xycols(
        frac_atoms, [radii, gidx], nbx, nby
    )
    cstarts_b = jnp.searchsorted(
        keys_b, jnp.arange(nbx * stride + 1, dtype=jnp.float32)
    )

    n_z = -(-col_cap // chunk)
    # BAND-MAJOR slot order (z-chunk index minor): candidate atoms sort
    # to the front of each column, so the chunks that must run the
    # blocker pass concentrate in band 0 (slots [0, n_cols)) — the
    # step-level skip below then takes its branch on ~n_cols/c_batch
    # contiguous steps instead of scattering taken branches (each taken
    # conditional pays real dispatch overhead) across the whole map
    cc = jnp.arange(n_cols * n_z, dtype=jnp.int32) % n_cols
    zi = jnp.arange(n_cols * n_z, dtype=jnp.int32) // n_cols
    natural = (c_bounds[cc] + zi * chunk).astype(jnp.int32)
    row_end = c_bounds[cc + 1].astype(jnp.int32)
    row0 = jnp.minimum(natural, jnp.maximum(n - chunk, 0))
    empty = natural >= row_end
    valid_lo = jnp.where(empty, jnp.int32(0), natural)
    valid_hi = jnp.where(empty, jnp.int32(0), row_end)

    cbx, cby = cc // nby, cc % nby
    b0 = (
        ((cbx[:, None] + jnp.array([-1, 0, 1])[None, :]) % nbx) * stride
        + cby[:, None]
    )  # [C, 3] shifted-y start columns
    st = cstarts_b[b0.reshape(-1)].reshape(-1, 3)
    en = cstarts_b[(b0 + 3).reshape(-1)].reshape(-1, 3)
    missed = missed | jnp.any((en - st) > window)
    st = jnp.minimum(st, keys_b.shape[0] - window).astype(jnp.int32)
    uc = jnp.stack(
        [
            (cbx.astype(jnp.float32) + 0.5) / nbx,
            (cby.astype(jnp.float32) + 0.5) / nby,
        ],
        axis=1,
    )  # [C, 2]

    k_dirs = dirs.shape[0]
    nudge_f = matvec3(dirs * jnp.float32(0.2), inv_cell)  # [K, 3]

    def linear_idx(fpts):
        f = fpts - jnp.floor(fpts)
        idx = jnp.minimum((f * gvec).astype(jnp.int32), gvec - 1)
        return (
            idx[..., 0] * grid[1] + idx[..., 1]
        ) * grid[2] + idx[..., 2]

    def chunk_cheap(r0, vlo, vhi):
        pl = jax.lax.dynamic_slice(centers_pl, (0, r0), (6, chunk))
        rows = r0 + jnp.arange(chunk, dtype=jnp.int32)
        live = (rows >= vlo) & (rows < vhi)
        cand_any = jnp.any((pl[5] > 0) & live)
        return pl, live, cand_any

    def chunk_heavy(pl, live, st3, center):
        """Points + blocker-window validity for one chunk — only runs
        for steps whose chunks contain a candidate atom."""
        fa = pl[:3].T  # [chunk, 3]
        ra = pl[3]
        gi = pl[4]
        fa_u = jnp.concatenate(
            [fa[:, :2] - jnp.round(fa[:, :2] - center[None, :]),
             fa[:, 2:3]],
            axis=1,
        )
        centers_cart = matvec3(fa_u, cell)
        pts = (
            centers_cart[:, None, :]
            + (ra[:, None, None] + r_probe) * dirs[None]
        ).reshape(chunk * k_dirs, 3)  # [P, 3]
        fp = matvec3(pts, inv_cell)  # [P, 3]
        gi_p = jnp.repeat(gi, k_dirs)

        # per-slice, per-axis accumulation: concatenating the three
        # runs materializes [P, 3W, 3] difference tensors that spill
        valid = None
        for s in range(3):
            cnd = jax.lax.dynamic_slice(
                blockers_pl, (0, st3[s]), (5, window)
            )
            wxy = cnd[:2] - jnp.round(cnd[:2] - center[:, None])
            wz = cnd[2]
            wr = cnd[3]
            wg = cnd[4]
            w_cart = matvec3(
                jnp.concatenate([wxy, wz[None]], axis=0).T, cell
            )  # [W, 3]
            zshift = jnp.round(fp[:, 2:3] - wz[None, :])  # [P, W]
            dxc = pts[:, 0:1] - w_cart[None, :, 0] - zshift * cell_z[0]
            dyc = pts[:, 1:2] - w_cart[None, :, 1] - zshift * cell_z[1]
            dzc = pts[:, 2:3] - w_cart[None, :, 2] - zshift * cell_z[2]
            d2 = dxc * dxc + dyc * dyc + dzc * dzc  # [P, W]
            thr2 = (wr + jnp.float32(r_probe - 1e-4)) ** 2
            self_m = wg[None, :] == gi_p[:, None]
            thr2 = jnp.where(self_m, -1.0, thr2[None, :])
            ok = jnp.all(d2 > thr2, axis=-1)
            valid = ok if valid is None else (valid & ok)

        valid = valid.reshape(chunk, k_dirs) & live[:, None]
        fp = fp.reshape(chunk, k_dirs, 3)
        return valid, linear_idx(fp), linear_idx(fp + nudge_f[None])

    # fat steps: several chunks per map iteration (thin steps cost
    # loop overhead, and each step whose conditional TAKES the heavy
    # branch pays a dispatch).
    # Pad the slot count to a multiple of 8 with empty slots
    # (valid_lo == valid_hi == 0 -> live False, cand_any False: the
    # skip branch, zero contribution) instead of letting divisibility
    # force a small batch: 81 cols x 7 z-chunks = 567 slots would
    # otherwise drop to c_batch=3 (189 steps, ~27 taken branches in
    # band 0) where padding to 568 keeps c_batch=8 (71 steps, ~11).
    n_chunks_tot = n_cols * n_z
    pad = (-n_chunks_tot) % c_batch
    if pad:
        zi32 = jnp.zeros(pad, jnp.int32)
        row0 = jnp.concatenate([row0, zi32])
        valid_lo = jnp.concatenate([valid_lo, zi32])
        valid_hi = jnp.concatenate([valid_hi, zi32])
        st = jnp.concatenate([st, jnp.zeros((pad, 3), jnp.int32)])
        uc = jnp.concatenate([uc, jnp.zeros((pad, 2), jnp.float32)])

    def batch_counts(args):
        r0b, vlob, vhib, st3b, centerb = args
        cheap = [
            chunk_cheap(r0b[t], vlob[t], vhib[t])
            for t in range(c_batch)
        ]
        pred = cheap[0][2]
        for t in range(1, c_batch):
            pred = pred | cheap[t][2]

        def heavy(_):
            outs = [
                chunk_heavy(cheap[t][0], cheap[t][1], st3b[t],
                            centerb[t])
                for t in range(c_batch)
            ]
            return tuple(jnp.stack(o) for o in zip(*outs))

        def skip(_):
            return (
                jnp.zeros((c_batch, chunk, k_dirs), bool),
                jnp.zeros((c_batch, chunk, k_dirs), jnp.int32),
                jnp.zeros((c_batch, chunk, k_dirs), jnp.int32),
            )

        # one conditional per STEP: a taken branch pays a dispatch,
        # so branch on
        # whole steps — band-major slot order clusters candidate chunks
        # into the first n_cols slots, making non-band-0 steps all-skip
        valid, i1, i2 = jax.lax.cond(pred, heavy, skip, operand=None)
        gi_out = jnp.stack([
            jnp.where(c[1], c[0][4], -1.0) for c in cheap
        ])
        ra = jnp.stack([c[0][3] for c in cheap])
        return valid, i1, i2, gi_out, ra

    batched = tuple(
        a.reshape(-1, c_batch, *a.shape[1:])
        for a in (row0, valid_lo, valid_hi, st, uc)
    )
    valid, i_pt, i_nu, gis, rs = jax.lax.map(batch_counts, batched)
    s_tot = (n_chunks_tot + pad) * chunk
    k = dirs.shape[0]
    return (
        valid.reshape(s_tot, k), i_pt.reshape(s_tot, k),
        i_nu.reshape(s_tot, k),
        gis.reshape(s_tot).astype(jnp.int32), rs.reshape(s_tot),
        missed,
    )


def classify_surface_points(valid, idx_pt, idx_nudge, accessible,
                            pocket):
    """Flat-gather classification of ``surface_valid_columns`` output:
    (acc_counts i32[S], nacc_counts i32[S]) per slot. Accessible and
    pocket are disjoint, so one exclusive i8 code field serves both
    lookups."""
    code = (
        accessible.astype(jnp.int8) + 2 * pocket.astype(jnp.int8)
    ).reshape(-1)
    c1 = code[idx_pt.reshape(-1)].reshape(idx_pt.shape)
    c2 = code[idx_nudge.reshape(-1)].reshape(idx_nudge.shape)
    acc = (c1 == 1) | (c2 == 1)
    poc = (c1 == 2) | (c2 == 2)
    acc_pt = valid & acc
    nacc_pt = valid & ~acc & poc
    return (
        jnp.sum(acc_pt, axis=1).astype(jnp.int32),
        jnp.sum(nacc_pt, axis=1).astype(jnp.int32),
    )


# --------------------------------------------------------------------------
# Two-level sorted windows: (x-slab, y-window) candidate pruning
# --------------------------------------------------------------------------


def _sort_atoms_slab_y(frac_atoms, radii, nbx: int, y_img: float):
    """Sort atoms (plus y-wrap images) by an (x-slab, y) composite key.

    Atoms are bucketed into ``nbx`` fractional-x slabs and sorted by
    ``slab * 2 + fy`` so each slab's run is y-ordered; atoms with
    ``fy < y_img`` get an image at ``fy + 1`` within the same slab
    (key + 1), which makes every y-window query a single contiguous
    range even when it wraps the cell. Invalid image rows carry key
    1e9 and sort to the global tail, beyond every slab.

    Returns (keys, x, y, z, r), each f32[2N] in sorted order.
    """
    fx = frac_atoms[:, 0] - jnp.floor(frac_atoms[:, 0])
    fy = frac_atoms[:, 1] - jnp.floor(frac_atoms[:, 1])
    fz = frac_atoms[:, 2] - jnp.floor(frac_atoms[:, 2])
    slab = jnp.minimum((fx * nbx).astype(jnp.int32), nbx - 1).astype(
        jnp.float32
    )
    key0 = slab * 2.0 + fy
    key1 = jnp.where(fy < y_img, key0 + 1.0, 1e9)
    keys = jnp.concatenate([key0, key1])
    xs = jnp.concatenate([fx, fx])
    ys = jnp.concatenate([fy, fy + 1.0])
    zs = jnp.concatenate([fz, fz])
    rs = jnp.concatenate([radii, radii])
    return jax.lax.sort(
        (keys, xs, ys, zs, rs), dimension=0, num_keys=1
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "grid", "dmax", "dxa", "dya", "tvx", "tvy", "nbx", "k_slabs",
        "window",
    ),
)
def distance_grid_windowed2(
    frac_atoms,  # f32[N, 3], no padding rows
    cell,
    radii,  # f32[N]
    grid,
    dmax: float,
    dxa: float,  # fractional-x reach: (dmax + max radius) / slab width x
    dya: float,  # fractional-y reach
    tvx: int = 4,
    tvy: int = 16,
    nbx: int = 8,
    k_slabs: int = 3,
    window: int = 512,
):
    """Clamped distance field via TWO-level sorted windows.

    Each (tvx, tvy, Gz) voxel tile tests only atoms from ``k_slabs``
    x-slabs, each restricted to a ``window``-wide y-ordered run — the
    candidate count scales with the tile's (x + 2 reach) x (y + 2
    reach) footprint instead of the full y-z slab of the one-level
    version. Coverage is exact by construction (slabs cover the x
    reach, y-images cover wrap), and per-(tile, slab) candidate counts
    are verified by binary search: any overflow raises the missed flag.

    Returns (f32[Gx, Gy, Gz] clamped at dmax, missed bool[]).
    """
    gx, gy, gz = grid
    assert gx % tvx == 0 and gy % tvy == 0, "tiles must divide the grid"
    n = frac_atoms.shape[0]
    n_i, n_j = gx // tvx, gy // tvy
    ry = (tvy - 1) / gy + 2 * dya
    rx = (tvx - 1) / gx + 2 * dxa
    assert ry < 1.0, "y reach covers the cell; use the 1-level kernel"
    assert k_slabs >= int(np.ceil(rx * nbx)) + 1, (
        f"k_slabs={k_slabs} cannot cover x reach {rx} with nbx={nbx}"
    )

    keys, xs_, ys_, zs_, rs_ = _sort_atoms_slab_y(frac_atoms, radii, nbx, ry)

    # per-(tile_i, slab k) slab ids and per-(tile_j) wrapped y windows
    x_lo = (np.arange(n_i) * tvx + 0.5) / gx - dxa  # [n_i]
    slab0 = np.floor((x_lo % 1.0) * nbx).astype(np.int64)  # [n_i]
    slabs = (slab0[:, None] + np.arange(k_slabs)[None, :]) % nbx  # [n_i, K]
    y_lo = ((np.arange(n_j) * tvy + 0.5) / gy - dya) % 1.0  # [n_j]

    q_lo = (
        slabs[:, None, :] * 2.0 + y_lo[None, :, None]
    ).astype(np.float32)  # [n_i, n_j, K]
    q_hi = (q_lo + ry).astype(np.float32)
    starts = jnp.searchsorted(keys, jnp.asarray(q_lo.reshape(-1)))
    ends = jnp.searchsorted(keys, jnp.asarray(q_hi.reshape(-1)))
    missed = jnp.any((ends - starts) > window)
    starts = starts.reshape(n_i, n_j, k_slabs)

    # voxel fractional coordinates as a 4-d array for tile slicing
    ii = (jnp.arange(gx) + 0.5) / gx
    jj = (jnp.arange(gy) + 0.5) / gy
    kk = (jnp.arange(gz) + 0.5) / gz
    vf3 = jnp.stack(jnp.meshgrid(ii, jj, kk, indexing="ij"), axis=-1)

    n_tiles = n_i * n_j
    tile_ti = jnp.arange(n_tiles, dtype=jnp.int32) // n_j
    tile_tj = jnp.arange(n_tiles, dtype=jnp.int32) % n_j

    def tile_min(args):
        ti, tj, st = args  # st: [K]
        v = jax.lax.dynamic_slice(
            vf3, (ti * tvx, tj * tvy, 0, 0), (tvx, tvy, gz, 3)
        ).reshape(-1, 3)
        d = jnp.full(v.shape[0], dmax, jnp.float32)
        for k in range(k_slabs):
            s = st[k]
            wx = jax.lax.dynamic_slice(xs_, (s,), (window,))
            wy = jax.lax.dynamic_slice(ys_, (s,), (window,))
            wz = jax.lax.dynamic_slice(zs_, (s,), (window,))
            wr = jax.lax.dynamic_slice(rs_, (s,), (window,))
            wk = jax.lax.dynamic_slice(keys, (s,), (window,))
            wf = jnp.stack([wx, wy, wz], axis=-1)
            df = v[:, None, :] - wf[None, :, :]
            df = df - jnp.floor(df + 0.5)
            dc = matvec3(df, cell)
            dk = jnp.sqrt(jnp.sum(dc * dc, axis=-1)) - wr[None, :]
            # rows past the slab run (key outside [q, q+ry]) are other
            # slabs' atoms or invalid images: still CORRECT candidates
            # (distance only shrinks the min if genuinely close) except
            # the 1e9-key image tail whose coordinates are real atoms
            # too — so no masking is needed; extra rows only cost time
            dk = jnp.where(wk[None, :] < 5e8, dk, jnp.inf)
            d = jnp.minimum(d, jnp.min(dk, axis=-1))
        return d

    d = jax.lax.map(tile_min, (tile_ti, tile_tj, starts.reshape(-1, k_slabs)))
    d = d.reshape(n_i, n_j, tvx, tvy, gz).transpose(0, 2, 1, 3, 4)
    return d.reshape(gx, gy, gz), missed
