"""
Fused on-device pair engine — the device replacement for the reference's
three native pair/neighbor backends (asap3 C++ RDF accumulation,
amof/rdf.py:87-114; ASE neighbor_list, amof/atom.py:82; pymatgen
get_all_neighbors, amof/coordination/core.py:62).

One tiled pass over all (i, j) pairs of a frame produces, on device:

  * species-pair-resolved distance histograms (RDF),
  * per-pair coordination counts under a cutoff matrix (CN),
  * fixed-capacity masked neighbor lists (BAD / graph construction).

Everything is shape-static: frames are vmapped, atoms are processed in
i-chunks vs all j, padding atoms carry species -1 and are masked out.
Minimum image is round-based (exact within half the minimum cell width —
the same domain the reference guarantees via rmax='half_cell',
amof/rdf.py:74-79).

Distance histograms accumulate by bin-index scatter-add. The angle
histograms of the BAD kernel use a hi/lo one-hot decomposition
contracted as a matrix product instead (``_onehot_histogram``;
counts[hi, lo] += onehot_hi^T @ onehot_lo, cf. CADISHI,
arXiv:1808.01478).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

WRAP_EPS = 1e-7


def _pick_chunk(n: int, target: int = 256) -> int:
    """Largest chunk <= target dividing the padded atom count."""
    return math.gcd(n, target) if n % target else target


def pad_atoms(positions: np.ndarray, species_idx: np.ndarray, multiple: int = 256):
    """Pad the atom axis to a multiple; padding gets species -1."""
    n = positions.shape[-2]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return positions, species_idx
    pos_pad = np.concatenate(
        [positions, np.zeros(positions.shape[:-2] + (n_pad, 3), positions.dtype)],
        axis=-2,
    )
    sp_pad = np.concatenate([species_idx, np.full(n_pad, -1, species_idx.dtype)])
    return pos_pad, sp_pad


def matvec3(v, m):
    """Row-vector 3-matrix product v @ m as unrolled multiply-adds.

    Deliberately NOT a dot/matmul: a float32 contraction may run at
    reduced precision (TF32 on the GPU), and a K=3 contraction would
    waste a matrix unit anyway — elementwise FMAs keep full f32.
    """
    return jnp.stack(
        [
            v[..., 0] * m[0, 0] + v[..., 1] * m[1, 0] + v[..., 2] * m[2, 0],
            v[..., 0] * m[0, 1] + v[..., 1] * m[1, 1] + v[..., 2] * m[2, 1],
            v[..., 0] * m[0, 2] + v[..., 1] * m[1, 2] + v[..., 2] * m[2, 2],
        ],
        axis=-1,
    )


def min_image_delta(delta, cell, inv_cell):
    """Round-based minimum image (device). delta [..., 3]."""
    frac = matvec3(delta, inv_cell)
    frac = frac - jnp.floor(frac + (0.5 + WRAP_EPS))
    return matvec3(frac, cell)


ONEHOT_HISTOGRAM_BLOCK = 8192  # bounds the one-hot working set


def _onehot_histogram(k, weight, total: int, lo: int = 128,
                      block: int = None):
    """Histogram of integer indices k (any shape) into ``total`` slots via
    a hi/lo one-hot decomposition contracted as matrix products:
    counts[hi, lo] += onehot_hi^T @ onehot_lo, accumulated over blocks of
    at most ``block`` entries to bound the one-hot working set.

    One-hot operands are bf16 (0/1 exact) with f32 accumulation; per-dot
    partial counts <= block stay exact. ``k`` may contain the sentinel
    ``total`` (overflow); an extra hi row absorbs it and is dropped.

    CONTRACT: ``weight`` values must be exactly representable in
    bfloat16 (all call sites pass 0/1 masks) — the weight is multiplied
    into the bf16 one-hot operand, so a general f32 weight would
    silently round to 8 mantissa bits. Apply non-binary weights (e.g.
    per-frame volume) to the f32 result instead (ADVICE r1).
    """
    if block is None:
        block = ONEHOT_HISTOGRAM_BLOCK
    assert lo & (lo - 1) == 0, "lo must be a power of two"
    lo_bits = lo.bit_length() - 1
    hi = -(-total // lo) + 1  # +1 overflow row
    kf = k.reshape(-1)
    wf = weight.reshape(-1)
    n = kf.shape[0]
    pad = (-n) % block
    if pad:
        kf = jnp.concatenate([kf, jnp.full(pad, total, kf.dtype)])
        wf = jnp.concatenate([wf, jnp.zeros(pad, wf.dtype)])
    n_blocks = kf.shape[0] // block
    # narrow key dtype when the key space fits: halves compare traffic
    kdt = jnp.int16 if total + 1 < 2**15 else jnp.int32
    iota_hi = jax.lax.broadcasted_iota(kdt, (1, hi), 1)
    iota_lo = jax.lax.broadcasted_iota(kdt, (1, lo), 1)

    def body(i, acc):
        kb = jax.lax.dynamic_slice(kf, (i * block,), (block,))
        wb = jax.lax.dynamic_slice(wf, (i * block,), (block,))
        # shifts, not div/mod: integer division is slow
        k_hi = jnp.right_shift(kb, lo_bits).astype(kdt)
        k_lo = jnp.bitwise_and(kb, lo - 1).astype(kdt)
        oh_hi = (k_hi[:, None] == iota_hi).astype(jnp.bfloat16)
        oh_hi = oh_hi * wb[:, None].astype(jnp.bfloat16)
        oh_lo = (k_lo[:, None] == iota_lo).astype(jnp.bfloat16)
        return acc + jax.lax.dot_general(
            oh_hi, oh_lo,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    counts2d = jax.lax.fori_loop(
        0, n_blocks, body, jnp.zeros((hi, lo), jnp.float32)
    )
    return counts2d.reshape(-1)[:total]


def _scatter_histogram(k, weight, total: int):
    return jnp.zeros(total, jnp.float32).at[k.reshape(-1)].add(
        weight.reshape(-1), mode="drop"
    )


def _within_cutoff(d2, si_chunk, species_idx, cutoff_matrix, n_species):
    """bool[chunk, N]: d2 < cutoff(s_i, s_j)^2, without per-pair gathers.

    Instead of a [chunk, N] gather from the cutoff table, gather the
    per-row cutoff columns (chunk-sized) and unroll a compare per
    species — elementwise work that fuses into the distance pass."""
    cut2_rows = (cutoff_matrix * cutoff_matrix)[jnp.maximum(si_chunk, 0)]
    sp_row = species_idx[None, :]
    valid = jnp.zeros(d2.shape, bool)
    for s in range(n_species):
        valid = valid | ((sp_row == s) & (d2 < cut2_rows[:, s][:, None]))
    return valid


def auto_window(cells, rc: float, n_pad: int, chunk: int):
    """Sorted-window width for the neighbor tables, or None when the
    window would not be narrower than the atom count.

    Sized from the density and the largest cutoff over the slab width
    along fractional axis 0 (min over frames). Pad rows carry uniformly
    spread sort keys, so the window scales with the PADDED atom count.
    A window that turns out too narrow is caught exactly by the tables'
    coverage check, never assumed."""
    if rc <= 0:
        return None
    c64 = np.asarray(cells, np.float64)
    bxc = np.cross(c64[:, 1], c64[:, 2])
    w0 = float(
        (np.abs(np.einsum("fi,fi->f", c64[:, 0], bxc))
         / np.linalg.norm(bxc, axis=1)).min()
    )
    est = 1.6 * n_pad * 2.0 * rc / max(w0, 1e-9) + 64
    window = int(-(-est // 128) * 128)
    return None if chunk + 2 * window >= n_pad else window


# --------------------------------------------------------------------------
# RDF: species-pair-resolved distance histogram
# --------------------------------------------------------------------------

def frame_rdf_counts(
    positions,  # [N, 3] (padded)
    cell,  # [3, 3]
    species_idx,  # [N] in [0, n_species), -1 for padding
    dr: float,
    n_species: int,
    bins: int,
    chunk: int = 256,
    i_start=0,
    n_i: int = None,
):
    """Distance histogram of one frame: counts [n_species², bins].

    counts[a*S+b, k] = #{ordered pairs (i in a, j in b), i != j,
                         k*dr <= d_ij < (k+1)*dr} with d the minimum-image
    distance. Semantics match the asap3 accumulation consumed at
    amof/rdf.py:87-114.

    ``i_start``/``n_i`` restrict the i-atom range — the hook the
    multichip path uses to shard the pair loop over an 'atoms' mesh axis
    (each device histograms its own i-slice against all j, partials are
    psum-merged).

    Each unordered pair is counted once (i < j) and the histogram is
    symmetrized at the end; when the i-range is static (single-chip
    path) the j-axis is tiled triangularly so the skipped half is never
    even touched.
    """
    n = positions.shape[0]
    if n_i is None:
        n_i = n
    # python-level dispatch (runs at trace time of the enclosing jit, so
    # i_start staticness is still observable here)
    static_range = isinstance(i_start, int)
    return _frame_rdf_counts_xla(
        positions, cell, species_idx, dr,
        i_start if not static_range else 0,
        n_species=n_species, bins=bins, chunk=chunk,
        n_i=n_i, i_start_static=i_start if static_range else None,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_species", "bins", "chunk", "n_i", "i_start_static"
    ),
)
def _frame_rdf_counts_xla(
    positions, cell, species_idx, dr, i_start_dyn,
    *, n_species, bins, chunk, n_i, i_start_static,
):
    n = positions.shape[0]
    static_range = i_start_static is not None
    i_start = i_start_static if static_range else i_start_dyn
    total = n_species * n_species * bins
    inv_cell = jnp.linalg.inv(cell)
    inv_dr = 1.0 / dr

    def tile_counts(i0, j0, tj):
        pi = jax.lax.dynamic_slice(positions, (i0, 0), (chunk, 3))
        si = jax.lax.dynamic_slice(species_idx, (i0,), (chunk,))
        pj = jax.lax.dynamic_slice(positions, (j0, 0), (tj, 3))
        sj = jax.lax.dynamic_slice(species_idx, (j0,), (tj,))
        delta = pj[None, :, :] - pi[:, None, :]
        delta = min_image_delta(delta, cell, inv_cell)
        d = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
        b = jnp.floor(d * inv_dr).astype(jnp.int32)
        gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (chunk, tj), 0)
        gj = j0 + jax.lax.broadcasted_iota(jnp.int32, (chunk, tj), 1)
        valid = (
            (gi < gj)
            & (si[:, None] >= 0)
            & (sj[None, :] >= 0)
            & (b < bins)
        )
        pair = si[:, None] * n_species + sj[None, :]
        k = jnp.where(valid, pair * bins + b, total)
        return _scatter_histogram(k, jnp.ones_like(d), total)

    if static_range:
        # triangular tiling: only j-tiles that can contain j > i
        tj = _pick_chunk(n, 2048)  # must divide n (dynamic_slice clamps)
        tiles = np.array(
            [
                (i_start + di, j0)
                for di in range(0, n_i, chunk)
                for j0 in range(0, n, tj)
                if j0 + tj > i_start + di
            ],
            dtype=np.int32,
        ).reshape(-1, 2)
        counts = jax.lax.map(
            lambda t: tile_counts(t[0], t[1], tj), jnp.asarray(tiles)
        )
    else:
        starts = i_start + jnp.arange(0, n_i, chunk)
        counts = jax.lax.map(lambda i0: tile_counts(i0, 0, n), starts)
    half = jnp.sum(counts, axis=0).reshape(n_species, n_species, bins)
    return half + half.transpose(1, 0, 2)


@functools.partial(
    jax.jit,
    static_argnames=("n_species", "bins", "chunk"),
)
def trajectory_rdf_counts(
    positions,  # [F, N, 3]
    cells,  # [F, 3, 3]
    species_idx,  # [N]
    dr: float,
    n_species: int,
    bins: int,
    chunk: int = None,
    frame_weights=None,  # [F] optional per-frame weight (e.g. volume)
):
    """Accumulate (optionally weighted) RDF counts over all frames, as
    one jitted program."""
    n = positions.shape[1]
    chunk = chunk or _pick_chunk(n)
    if frame_weights is None:
        frame_weights = jnp.ones(positions.shape[0], jnp.float32)

    def one(args):
        pos, cell, w = args
        return w * frame_rdf_counts(
            pos, cell, species_idx, dr, n_species, bins, chunk
        )

    # compensated frame accumulation: weighted bin sums reach 1e13+ at
    # 10k frames, past plain-f32 exactness (see ops/accum.py)
    from amof_tpu.ops import accum

    return accum.scan_sum(one, (positions, cells, frame_weights))


# --------------------------------------------------------------------------
# CN: per-species-pair coordination counts under a cutoff matrix
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_species", "chunk", "n_i"))
def frame_cn_counts(
    positions,  # [N, 3] (padded)
    cell,
    species_idx,  # [N], -1 padding
    cutoff_matrix,  # [S, S] symmetric, 0 disables a pair
    n_species: int,
    chunk: int = 256,
    i_start=0,
    n_i: int = None,
):
    """Total neighbor counts per ordered species pair: out[a, b] =
    #{(i in a, j in b) : d_ij < cutoff[a, b]} — the device equivalent of
    the per-atom counting loop at amof/cn.py:58-73 (summed over atoms;
    divide by N_a for the mean CN). ``i_start``/``n_i`` shard the i-atom
    range (see frame_rdf_counts).

    No scatters: counts[a, b] contract as one-hot matrix products
    (oh_i^T @ valid @ oh_j)."""
    n = positions.shape[0]
    if n_i is None:
        n_i = n
    inv_cell = jnp.linalg.inv(cell)
    sp_safe = jnp.maximum(species_idx, 0)
    iota_s = jax.lax.broadcasted_iota(jnp.int32, (1, n_species), 1)
    oh_j = (
        (sp_safe[:, None] == iota_s) & (species_idx[:, None] >= 0)
    ).astype(jnp.bfloat16)  # [N, S]

    def chunk_counts(i0):
        pi = jax.lax.dynamic_slice(positions, (i0, 0), (chunk, 3))
        si = jax.lax.dynamic_slice(species_idx, (i0,), (chunk,))
        delta = positions[None, :, :] - pi[:, None, :]
        delta = min_image_delta(delta, cell, inv_cell)
        d2 = jnp.sum(delta * delta, axis=-1)
        gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (chunk, n), 0)
        gj = jax.lax.broadcasted_iota(jnp.int32, (chunk, n), 1)
        # unordered pairs (i < j), symmetrized at the end — the cutoff
        # matrix is symmetric so both directions agree
        valid = (
            (gi < gj)
            & (si[:, None] >= 0)
            & _within_cutoff(d2, si, species_idx, cutoff_matrix, n_species)
        ).astype(jnp.bfloat16)
        oh_i = (si[:, None] == iota_s).astype(jnp.bfloat16)  # [chunk, S]
        per_i = jax.lax.dot_general(  # [chunk, S_j]
            valid, oh_j,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        # per_i holds per-center counts, which can pass TF32's 2^11
        # exact integers: ask for full f32
        return jax.lax.dot_general(  # [S_i, S_j]
            oh_i.astype(jnp.float32), per_i,
            dimension_numbers=(((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )

    starts = i_start + jnp.arange(0, n_i, chunk)
    counts = jax.lax.map(chunk_counts, starts)
    half = jnp.sum(counts, axis=0)
    return half + half.T


# --------------------------------------------------------------------------
# Neighbor capture: fixed-capacity masked neighbor arrays
# --------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("max_neighbors", "chunk", "n_i")
)
def frame_neighbor_payload_table(
    positions,  # [N, 3] (padded)
    cell,
    species_idx,  # [N]
    cutoff_matrix,  # [S, S]
    max_neighbors: int = 16,
    chunk: int = 256,
    i_start=0,
    n_i: int = None,
):
    """Neighbor table that emits positions and species directly.

    During each masked min-reduction of the compaction the selected
    neighbor's payload is extracted with masked sums, which fuse into
    the reduction — no index gathers anywhere.

    Returns:
        nbr_pos f32[n_i, K, 3], nbr_sp i32[n_i, K] (-1 empty),
        nbr_cnt i32[n_i], overflow bool[]
    """
    n = positions.shape[0]
    if n_i is None:
        n_i = n
    inv_cell = jnp.linalg.inv(cell)
    n_species = cutoff_matrix.shape[0]
    px = positions[:, 0][None, :]
    py = positions[:, 1][None, :]
    pz = positions[:, 2][None, :]
    sp_row = species_idx[None, :].astype(jnp.float32)

    def chunk_table(i0):
        pi = jax.lax.dynamic_slice(positions, (i0, 0), (chunk, 3))
        si = jax.lax.dynamic_slice(species_idx, (i0,), (chunk,))
        delta = positions[None, :, :] - pi[:, None, :]
        delta = min_image_delta(delta, cell, inv_cell)
        d2 = jnp.sum(delta * delta, axis=-1)  # [chunk, N]
        gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (chunk, n), 0)
        gj = jax.lax.broadcasted_iota(jnp.int32, (chunk, n), 1)
        valid = (
            (gi != gj)
            & (si[:, None] >= 0)
            & _within_cutoff(d2, si, species_idx, cutoff_matrix, n_species)
        )
        cnt = jnp.sum(valid, axis=1).astype(jnp.int32)
        score = jnp.where(valid, gj, n)
        pos_cols, sp_cols = [], []
        for _ in range(max_neighbors):
            picked = jnp.min(score, axis=1)  # [chunk]
            sel = (score == picked[:, None]) & (picked[:, None] < n)
            selected_f = sel.astype(jnp.float32)
            x = jnp.sum(selected_f * px, axis=1)
            y = jnp.sum(selected_f * py, axis=1)
            z = jnp.sum(selected_f * pz, axis=1)
            s = jnp.where(
                picked < n,
                jnp.sum(selected_f * sp_row, axis=1).astype(jnp.int32),
                -1,
            )
            pos_cols.append(jnp.stack([x, y, z], axis=-1))
            sp_cols.append(s)
            score = jnp.where(sel, n, score)
        nbr_pos = jnp.stack(pos_cols, axis=1)  # [chunk, K, 3]
        nbr_sp = jnp.stack(sp_cols, axis=1)  # [chunk, K]
        return nbr_pos, nbr_sp, cnt

    starts = i_start + jnp.arange(0, n_i, chunk)
    nbr_pos, nbr_sp, nbr_cnt = jax.lax.map(chunk_table, starts)
    k = max_neighbors
    nbr_pos = nbr_pos.reshape(n_i, k, 3)
    nbr_sp = nbr_sp.reshape(n_i, k)
    nbr_cnt = nbr_cnt.reshape(n_i)
    overflow = jnp.any(nbr_cnt > max_neighbors)
    return nbr_pos, nbr_sp, jnp.minimum(nbr_cnt, max_neighbors), overflow


@functools.partial(
    jax.jit, static_argnames=("n_species", "chunk", "window")
)
def frame_cn_counts_windowed(
    positions,  # [N, 3] (padded)
    cell,
    species_idx,  # [N]
    cutoff_matrix,  # [S, S]
    n_species: int,
    chunk: int = 256,
    window: int = 1024,
):
    """CN counts via the sorted-window pass: O(N*W) instead of the
    O(N^2) ``frame_cn_counts``. Returns (cn f32[S, S], missed bool[]);
    on a window miss the caller falls back to the full pass. Which of
    the two passes a backend runs is ``engines.for_backend().cn_table``.
    """
    out = frame_neighbor_payload_table_sorted(
        positions, cell, species_idx, cutoff_matrix, max_neighbors=1,
        chunk=chunk, window=window, emit_cn=True, counts_only=True,
    )
    return out[6], out[3]


def frame_neighbor_payload_table_sorted(
    positions,  # [N, 3] (padded)
    cell,
    species_idx,  # [N]
    cutoff_matrix,  # [S, S]
    max_neighbors: int = 16,
    chunk: int = 256,
    window: int = 1024,
    i_start=0,
    n_i: int = None,
    emit_cn: bool = False,
    counts_only: bool = False,
):
    """Sorted-window neighbor table: the bandwidth-cheap variant of
    ``frame_neighbor_payload_table``.

    ``counts_only`` skips the K-slot compaction entirely (table outputs
    are zeros) and the returned flag covers ONLY the window-coverage
    check — the mode behind ``frame_cn_counts_windowed``, where the
    per-pair counts (emit_cn) are the whole product.

    The K-slot compaction of the full table makes ~7 masked passes over a
    [chunk, N] workspace per slot, bound by memory traffic. But neighbor
    cutoffs (2-3 A) are tiny next to the box (50+ A):
    after sorting atoms by one wrapped fractional coordinate, all true
    neighbors of a center lie within ``window`` positions of it in sorted
    order, so the compaction runs over a [chunk, chunk + 2*window] slice
    instead of [chunk, N].

    The window is a *candidate* set, not an assumption: a vectorized
    binary search verifies, per center, that EVERY atom within the
    worst-case fractional-x reach (max cutoff / x-slab width) lies
    within ``window`` sorted positions — a sufficient condition for the
    window to contain all true neighbors — and any violation raises the
    returned flag (same contract as the capacity-overflow flag). This
    check is O(N log N); the previous revision verified by recounting
    neighbors against all N atoms, an O(N^2) pass that cost as much as
    the RDF kernel itself.

    Centers come out in sorted order; the returned ``center_pos`` /
    ``center_sp`` identify them (histogram consumers are order-invariant).
    The neighbor *sets* per center are identical to the full table's, so
    downstream angle histograms are bit-exact against it.

    Requires ``chunk + 2*window < N`` (otherwise a wrap-around window
    could contain the same atom twice); callers fall back to the full
    table below that size.

    With ``emit_cn`` the windowed validity mask is additionally
    contracted into per-species-pair neighbor counts (one-hot matrix
    products, like frame_cn_counts but counting ordered pairs directly)
    — CN analysis rides the same pass for free; exact whenever the
    window check passes.

    Returns:
        nbr_pos f32[n_i, K, 3], nbr_sp i32[n_i, K] (-1 empty),
        nbr_cnt i32[n_i] (exact, from the full-range pass),
        flag bool[] (overflow OR window miss — results incomplete),
        center_pos f32[n_i, 3], center_sp i32[n_i]
        [, cn f32[S, S] when emit_cn]
    """
    n = positions.shape[0]
    if n_i is None:
        n_i = n
    assert chunk + 2 * window < n, "window too wide; use the full table"
    inv_cell = jnp.linalg.inv(cell)
    n_species = cutoff_matrix.shape[0]
    width = chunk + 2 * window
    # ---- sort every payload channel by wrapped fractional coord 0 ----
    frac0 = matvec3(positions, inv_cell)[:, 0]
    frac0 = frac0 - jnp.floor(frac0)
    # padding rows get keys spread UNIFORMLY through [0, 1): windows
    # then dilute by the pad fraction (~15% for the species-blocked
    # layout) instead of having to be wider than the whole pad block
    # clustered at the tail (pads are species -1, masked from validity)
    pad_spread = (jnp.arange(n, dtype=frac0.dtype) + 0.5) / n
    key = jnp.where(species_idx >= 0, frac0, pad_spread)
    keys_s, xs, ys, zs, sps = jax.lax.sort(
        (key, positions[:, 0], positions[:, 1], positions[:, 2],
         species_idx.astype(jnp.int32)),
        dimension=0, num_keys=1,
    )
    pos_s = jnp.stack([xs, ys, zs], axis=-1)
    # circular extension: ext[k] = sorted[(k - window) mod N]
    def ext(a):
        return jnp.concatenate([a[n - window:], a, a[:window]], axis=0)
    ext_x, ext_y, ext_z = ext(xs), ext(ys), ext(zs)
    ext_sp = ext(sps)
    ext_sp_f = ext_sp.astype(jnp.float32)
    iota_s = jax.lax.broadcasted_iota(jnp.int32, (1, n_species), 1)

    # ---- positional-window coverage check (O(N log N), exact) ----
    # every atom within the worst-case x-reach of a center must sit
    # within `window` sorted positions of it; the circular span counts
    # run THROUGH the padding tail exactly like the ext windows do
    w0x = jnp.abs(jnp.linalg.det(cell)) / jnp.linalg.norm(
        jnp.cross(cell[1], cell[2])
    )
    rxa = jnp.max(cutoff_matrix) / w0x + 1e-6
    p_idx = i_start + jnp.arange(n_i, dtype=jnp.int32)
    cx = jax.lax.dynamic_slice(keys_s, (i_start,), (n_i,))
    creal = jax.lax.dynamic_slice(sps, (i_start,), (n_i,)) >= 0
    x_hi = cx + rxa
    x_lo = cx - rxa
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
    win_missed = jnp.any(
        creal & ((span_r > window) | (span_l > window))
    )

    def chunk_table(c0):
        # centers = sorted rows [c0, c0+chunk)
        pi = jax.lax.dynamic_slice(pos_s, (c0, 0), (chunk, 3))
        si = jax.lax.dynamic_slice(sps, (c0,), (chunk,))

        # windowed candidates: ext[c0 : c0+width) = sorted[c0-W, c0+chunk+W)
        wx = jax.lax.dynamic_slice(ext_x, (c0,), (width,))
        wy = jax.lax.dynamic_slice(ext_y, (c0,), (width,))
        wz = jax.lax.dynamic_slice(ext_z, (c0,), (width,))
        wsp = jax.lax.dynamic_slice(ext_sp, (c0,), (width,))
        wsp_f = jax.lax.dynamic_slice(ext_sp_f, (c0,), (width,))
        wpos = jnp.stack([wx, wy, wz], axis=-1)
        delta = wpos[None, :, :] - pi[:, None, :]
        d2 = jnp.sum(
            jnp.square(min_image_delta(delta, cell, inv_cell)), axis=-1
        )
        col = jax.lax.broadcasted_iota(jnp.int32, (chunk, width), 1)
        self_col = window + jax.lax.broadcasted_iota(
            jnp.int32, (chunk, width), 0
        )
        valid = (
            (col != self_col)
            & (si >= 0)[:, None]
            & _within_cutoff(d2, si, wsp, cutoff_matrix, n_species)
        )
        cnt_win = jnp.sum(valid, axis=1).astype(jnp.int32)
        if emit_cn:
            oh_w = (
                (jnp.maximum(wsp, 0)[:, None] == iota_s)
                & (wsp[:, None] >= 0)
            ).astype(jnp.bfloat16)  # [width, S]
            per_i = jax.lax.dot_general(  # [chunk, S_j]
                valid.astype(jnp.bfloat16), oh_w,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            oh_i = (si[:, None] == iota_s).astype(jnp.float32)
            # per-center counts may pass TF32's 2^11 exact integers
            cn = jax.lax.dot_general(  # [S_i, S_j]
                oh_i, per_i,
                dimension_numbers=(((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
        else:
            cn = jnp.zeros((n_species, n_species), jnp.float32)

        if counts_only:
            return (
                jnp.zeros((chunk, max_neighbors, 3), jnp.float32),
                jnp.full((chunk, max_neighbors), -1, jnp.int32),
                cnt_win, cn,
            )

        score = jnp.where(valid, col, width)
        pos_cols, sp_cols = [], []
        for _ in range(max_neighbors):
            picked = jnp.min(score, axis=1)  # [chunk]
            sel = (score == picked[:, None]) & (picked[:, None] < width)
            f = sel.astype(jnp.float32)
            x = jnp.sum(f * wx[None, :], axis=1)
            y = jnp.sum(f * wy[None, :], axis=1)
            z = jnp.sum(f * wz[None, :], axis=1)
            s = jnp.where(
                picked < width,
                jnp.sum(f * wsp_f[None, :], axis=1).astype(jnp.int32),
                -1,
            )
            pos_cols.append(jnp.stack([x, y, z], axis=-1))
            sp_cols.append(s)
            score = jnp.where(sel, width, score)
        nbr_pos = jnp.stack(pos_cols, axis=1)  # [chunk, K, 3]
        nbr_sp = jnp.stack(sp_cols, axis=1)
        return nbr_pos, nbr_sp, cnt_win, cn

    center_sp = jax.lax.dynamic_slice(sps, (i_start,), (n_i,))
    starts = i_start + jnp.arange(0, n_i, chunk)
    nbr_pos, nbr_sp, nbr_cnt, cn = jax.lax.map(chunk_table, starts)
    k = max_neighbors
    nbr_pos = nbr_pos.reshape(n_i, k, 3)
    nbr_sp = nbr_sp.reshape(n_i, k)
    nbr_cnt = nbr_cnt.reshape(n_i)
    cn = jnp.sum(cn, axis=0)
    flag = (
        win_missed if counts_only
        else win_missed | jnp.any(nbr_cnt > max_neighbors)
    )
    center_pos = jax.lax.dynamic_slice(pos_s, (i_start, 0), (n_i, 3))
    out = (
        nbr_pos, nbr_sp, jnp.minimum(nbr_cnt, max_neighbors), flag,
        center_pos, center_sp,
    )
    return out + (cn,) if emit_cn else out

@functools.partial(
    jax.jit, static_argnames=("max_neighbors", "chunk", "n_i")
)
def frame_neighbor_table(
    positions,  # [N, 3] (padded)
    cell,
    species_idx,  # [N]
    cutoff_matrix,  # [S, S]
    max_neighbors: int = 32,
    chunk: int = 256,
    i_start=0,
    n_i: int = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fixed-capacity neighbor table (indices, count, overflow flag).

    ``i_start``/``n_i`` restrict the centers to an i-atom slice (atom-axis
    sharding); neighbor indices stay global.

    Returns:
        nbr_idx  i32[n_i, K]: neighbor indices (n for empty slots)
        nbr_cnt  i32[n_i]:    number of neighbors of each atom
        overflow bool[]:      True if any atom exceeded K (report, don't
                              silently truncate — SURVEY.md §7 hard parts)
    """
    n = positions.shape[0]
    if n_i is None:
        n_i = n
    inv_cell = jnp.linalg.inv(cell)
    sp_safe = jnp.maximum(species_idx, 0)

    def chunk_table(i0):
        pi = jax.lax.dynamic_slice(positions, (i0, 0), (chunk, 3))
        si = jax.lax.dynamic_slice(species_idx, (i0,), (chunk,))
        delta = positions[None, :, :] - pi[:, None, :]
        delta = min_image_delta(delta, cell, inv_cell)
        d2 = jnp.sum(delta * delta, axis=-1)  # [chunk, N]
        gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (chunk, n), 0)
        gj = jax.lax.broadcasted_iota(jnp.int32, (chunk, n), 1)
        n_species = cutoff_matrix.shape[0]
        valid = (
            (gi != gj)
            & (si[:, None] >= 0)
            & _within_cutoff(d2, si, species_idx, cutoff_matrix, n_species)
        )
        cnt = jnp.sum(valid, axis=1).astype(jnp.int32)
        # compact valid columns with K successive masked min-reductions
        # (scatter-free; cheaper than top_k for small K); empty slots
        # hold the sentinel n, indices come out ascending
        score = jnp.where(valid, gj, n)  # [chunk, N]
        idx_cols = []
        for _ in range(max_neighbors):
            picked = jnp.min(score, axis=1)  # [chunk]
            idx_cols.append(picked)
            score = jnp.where(score == picked[:, None], n, score)
        idx = jnp.stack(idx_cols, axis=1).astype(jnp.int32)
        return idx, cnt

    starts = i_start + jnp.arange(0, n_i, chunk)
    nbr_idx, nbr_cnt = jax.lax.map(chunk_table, starts)
    nbr_idx = nbr_idx.reshape(n_i, max_neighbors)
    nbr_cnt = nbr_cnt.reshape(n_i)
    overflow = jnp.any(nbr_cnt > max_neighbors)
    return nbr_idx, jnp.minimum(nbr_cnt, max_neighbors), overflow
