"""
On-device bond-angle distribution kernel.

Replaces the reference's per-frame Python triplet loop + ASE
``get_angles(mic=True)`` (amof/bad.py:71-101) with a fused device pass:
fixed-capacity neighbor tables -> all neighbor-slot pairs -> minimum-image
angles -> histograms.

Instead of one masked histogram per requested spec (whose compile cost
scales with the wildcard enumeration), the kernel emits two
species-resolved tensors from which every B-A-B spec of the reference's
enumeration (amof/bad.py:122-133) is a slice or sum:

  * concrete[a, b, cn, theta]: angles with center species a and BOTH
    outer atoms of species b, bucketed by the center's count of
    b-species neighbors — spec (a, b);
  * center_any[a, cn, theta]: ALL angles at centers of species a,
    bucketed by the center's total neighbor count — spec (a, "X");
    summing over a gives ("X", "X").

(The only wildcard form the reference enumerates with a concrete second
species is none — "X" centers only pair with "X" outers.)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from amof_tpu.ops.pair_engine import (
    _onehot_histogram,
    frame_neighbor_payload_table,
    frame_neighbor_payload_table_sorted,
    min_image_delta,
)

# largest key space one one-hot histogram pass handles; ~5k hi-rows keep
# the blocked one-hot under ~80 MB (the 13-species plain-BAD case has
# 608k slots). Larger key spaces are SEGMENTED into passes of at most
# this size.
ONEHOT_SLOT_LIMIT = 640_000


def _segmented_onehot_histogram(key, weight, total: int,
                                seg_limit: int = ONEHOT_SLOT_LIMIT):
    """One-hot histogram over an arbitrarily large key space.

    Splits the key range into segments of <= ``seg_limit`` slots and
    runs one masked `_onehot_histogram` pass per segment: the total
    matrix-product work is unchanged (each key lands in exactly one
    segment) and only the mask/compare work repeats per segment, while
    the one-hot working set stays bounded. ``key == total`` stays a
    valid overflow sentinel (weight must be 0 there, as in
    `_onehot_histogram`).
    """
    if total <= seg_limit:
        return _onehot_histogram(key, weight, total)
    n_seg = -(-total // seg_limit)
    seg = -(-total // n_seg)
    parts = []
    for q in range(n_seg):
        k_local = key - q * seg
        in_seg = (k_local >= 0) & (k_local < seg)
        k_local = jnp.where(in_seg, k_local, seg)
        parts.append(
            _onehot_histogram(k_local, weight * in_seg, seg)
        )
    return jnp.concatenate(parts)[:total]


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_species", "bins", "max_neighbors", "chunk", "n_i", "by_cn",
        "window", "emit_cn",
    ),
)
def frame_bad_counts(
    positions,  # [N, 3] padded
    cell,  # [3, 3]
    species_idx,  # [N], -1 padding
    cutoff_matrix,  # [S, S]
    n_species: int,
    dtheta: float,
    bins: int,  # number of theta bins (reference: int(180//dtheta) + 1)
    max_neighbors: int = 24,
    chunk: int = 256,
    i_start=0,
    n_i: int = None,
    by_cn: bool = False,
    window: int = None,
    emit_cn: bool = False,
):
    """Angle histograms of one frame.

    ``i_start``/``n_i`` restrict the center atoms to an i-slice (atom-axis
    sharding; see pair_engine.frame_rdf_counts). With ``by_cn`` the
    histograms gain a coordination-number axis (BadByCn); key spaces
    beyond ONEHOT_SLOT_LIMIT are segmented.

    ``window`` selects the sorted-window neighbor table
    (pair_engine.frame_neighbor_payload_table_sorted): centers are
    processed in sorted order — histograms are order-invariant, so the
    result is bit-exact vs the full table — and the overflow flag also
    covers window misses. None, or a window too wide for N, uses the
    full table.

    ``emit_cn`` (sorted-window path only) additionally returns the
    per-species-pair neighbor-count matrix computed by the table's
    verification pass — equal to pair_engine.frame_cn_counts for the
    same cutoffs, at no extra pair pass.

    Returns:
        concrete  f32[S, S, K+1, bins]  (K+1 == 1 when by_cn=False)
        center_any f32[S, K+1, bins]
        overflow  bool[]  (capacity overflow, or a window miss)
        [, cn f32[S, S] when emit_cn]
    """
    n = positions.shape[0]
    if n_i is None:
        n_i = n
    if window is not None and chunk + 2 * window >= n:
        window = None
    k_cap = max_neighbors
    if window is None:
        assert not emit_cn, "emit_cn requires the sorted-window table"
        nbr_pos, nbr_sp, nbr_cnt, overflow = frame_neighbor_payload_table(
            positions, cell, species_idx, cutoff_matrix, max_neighbors,
            chunk, i_start=i_start, n_i=n_i,
        )
        center_pos = jax.lax.dynamic_slice(positions, (i_start, 0), (n_i, 3))
        center_sp = jax.lax.dynamic_slice(species_idx, (i_start,), (n_i,))
    else:
        (nbr_pos, nbr_sp, nbr_cnt, overflow, center_pos, center_sp,
         *cn_out) = frame_neighbor_payload_table_sorted(
            positions, cell, species_idx, cutoff_matrix, max_neighbors,
            chunk, window, i_start=i_start, n_i=n_i, emit_cn=emit_cn,
        )
    assert k_cap >= 2, "angle triplets need >= 2 neighbor slots"
    inv_cell = jnp.linalg.inv(cell)
    s2 = n_species * n_species
    cn_slots = (k_cap + 1) if by_cn else 1
    conc_total = s2 * cn_slots * bins
    any_total = n_species * cn_slots * bins

    def chunk_hist(local_i0, acc):
        conc_acc, any_acc = acc
        pj = jax.lax.dynamic_slice(
            nbr_pos, (local_i0, 0, 0), (chunk, k_cap, 3)
        )
        sj = jax.lax.dynamic_slice(nbr_sp, (local_i0, 0), (chunk, k_cap))
        cnt = jax.lax.dynamic_slice(nbr_cnt, (local_i0,), (chunk,))
        si = jax.lax.dynamic_slice(center_sp, (local_i0,), (chunk,))
        pi = jax.lax.dynamic_slice(center_pos, (local_i0, 0), (chunk, 3))
        slot_valid = sj >= 0
        vec = min_image_delta(pj - pi[:, None, :], cell, inv_cell)
        norm = jnp.sqrt(jnp.sum(vec * vec, axis=-1))
        unit = vec / jnp.maximum(norm, 1e-12)[..., None]

        # Triangle (k < l) slot-pair enumeration via static diagonal
        # slices: pairs at offset d are (slice[:-d], slice[d:]). This
        # enumerates each unordered pair exactly once — T = K(K-1)/2
        # columns instead of the K^2 grid the kk<ll mask would carve
        # half-dead — halving both the angle math and the per-key
        # one-hot histogram traffic. Static slices + one concat: no
        # gathers.
        def tri(x):
            return jnp.concatenate(
                [x[:, : k_cap - d] for d in range(1, k_cap)], axis=1
            )

        def tri_hi(x):
            return jnp.concatenate(
                [x[:, d:] for d in range(1, k_cap)], axis=1
            )

        uk, ul = tri(unit), tri_hi(unit)  # [chunk, T, 3]
        sk, sl = tri(sj), tri_hi(sj)  # [chunk, T]
        # elementwise contraction over coords (full f32; see
        # pair_engine.matvec3 for why not einsum/dot)
        cosang = jnp.sum(uk * ul, axis=-1)
        theta = jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
        tbin = jnp.minimum(jnp.floor(theta / dtheta).astype(jnp.int32),
                           bins - 1)

        pair_valid = (sk >= 0) & (sl >= 0) & (si >= 0)[:, None]

        # concrete: both outers share species b
        same = pair_valid & (sk == sl)
        b_sp = jnp.maximum(sk, 0)
        a_sp = jnp.maximum(si, 0)[:, None]

        if by_cn:
            # per-(center, b) neighbor counts: cn_b[chunk, S]
            onehot_sj = (
                sj[:, :, None]
                == jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_species), 2)
            )
            cn_b = jnp.sum(onehot_sj, axis=1).astype(jnp.int32)  # [chunk, S]
            cn_of_pair = jnp.take_along_axis(cn_b, b_sp, axis=1)  # [chunk, T]
            cn_all = jnp.broadcast_to(cnt[:, None], b_sp.shape)
        else:
            cn_of_pair = 0
            cn_all = 0

        key_c = (
            ((a_sp * n_species + b_sp) * cn_slots + cn_of_pair) * bins + tbin
        )
        key_c = jnp.where(same, key_c, conc_total)
        key_a = (a_sp * cn_slots + cn_all) * bins + tbin
        key_a = jnp.where(pair_valid, key_a, any_total)

        conc_acc = conc_acc + _segmented_onehot_histogram(
            key_c, same.astype(jnp.float32), conc_total
        )
        any_acc = any_acc + _segmented_onehot_histogram(
            key_a, pair_valid.astype(jnp.float32), any_total
        )
        return conc_acc, any_acc

    def body(c, acc):
        return chunk_hist(c * chunk, acc)

    acc_shape_c = conc_total
    acc_shape_a = any_total
    conc, any_ = jax.lax.fori_loop(
        0, n_i // chunk, body,
        (
            jnp.zeros(acc_shape_c, jnp.float32),
            jnp.zeros(acc_shape_a, jnp.float32),
        ),
    )
    conc = conc[:conc_total].reshape(n_species, n_species, cn_slots, bins)
    any_ = any_[:any_total].reshape(n_species, cn_slots, bins)
    if emit_cn:
        return conc, any_, overflow, cn_out[0]
    return conc, any_, overflow


def select_spec_counts(concrete, center_any, spec: Tuple[int, int]):
    """Counts [cn, theta] for one (center, outer) spec; -1 = wildcard."""
    a, b = spec
    if a >= 0 and b >= 0:
        return concrete[a, b]
    if a >= 0 and b < 0:
        return center_any[a]
    return center_any.sum(axis=0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_species", "bins", "max_neighbors", "chunk", "by_cn", "window",
    ),
)
def trajectory_bad_counts(
    positions,  # [F, N, 3]
    cells,  # [F, 3, 3]
    species_idx,
    cutoff_matrix,
    n_species,
    dtheta,
    bins,
    max_neighbors=24,
    chunk=256,
    by_cn=False,
    window=None,
):
    """Accumulate over frames, as one jitted program; returns
    (concrete, center_any, overflow)."""

    def one(args):
        pos, cell = args
        return frame_bad_counts(
            pos, cell, species_idx, cutoff_matrix, n_species, dtheta, bins,
            max_neighbors, chunk, by_cn=by_cn, window=window,
        )

    conc, any_, overflow = jax.lax.map(one, (positions, cells))
    return jnp.sum(conc, axis=0), jnp.sum(any_, axis=0), jnp.any(overflow)
