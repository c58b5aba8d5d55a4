"""
On-device bonded-graph kernels.

All-pairs BFS distances via repeated boolean matrix products on the device
— the device half of the ring-statistics engine (the combinatorial
enumeration runs in C++ on host consuming these distance matrices; see
amof_tpu/native). Also builds bond adjacency matrices from per-species
cutoff matrices (the RINGS input convention of zero-filled missing pairs,
amof/ring/core.py:234-240).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from amof_tpu.ops.pair_engine import min_image_delta

UNREACHED = 0xFFFF


@jax.jit
def bond_adjacency(positions, cell, species_idx, cutoff_matrix):
    """Boolean adjacency: d_ij < cutoff(s_i, s_j), minimum image.

    Full [N, N] — intended for the (small) graphs ring analysis runs on.
    Padding atoms (species -1) have no bonds.
    """
    n = positions.shape[0]
    inv_cell = jnp.linalg.inv(cell)
    delta = positions[None, :, :] - positions[:, None, :]
    delta = min_image_delta(delta, cell, inv_cell)
    d2 = jnp.sum(delta * delta, axis=-1)
    sp = jnp.maximum(species_idx, 0)
    cut = cutoff_matrix[sp[:, None], sp[None, :]]
    eye = jnp.eye(n, dtype=bool)
    return (
        (~eye)
        & (species_idx[:, None] >= 0)
        & (species_idx[None, :] >= 0)
        & (d2 < cut * cut)
    )


@functools.partial(jax.jit, static_argnames=("max_depth",))
def bfs_distances(adj, max_depth: int):
    """All-pairs shortest-path distances up to max_depth.

    Frontier expansion as f32 matrix products: reach_{k+1} = reach_k @ adj.
    Returns u16[N, N] with UNREACHED beyond max_depth.
    """
    n = adj.shape[0]
    adj_f = adj.astype(jnp.float32)
    eye = jnp.eye(n, dtype=bool)
    dist = jnp.where(
        eye, 0, jnp.where(adj, 1, UNREACHED)
    ).astype(jnp.uint16)
    reach = (eye | adj).astype(jnp.float32)

    def body(k, state):
        dist, reach = state
        # both operands are 0/1, exact in TF32 or bf16, and the sum is
        # only tested for > 0, which no rounding of positive terms can
        # flip: the default (possibly TF32) precision is exact here
        new_reach = (
            jax.lax.dot_general(
                reach, adj_f,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            > 0
        )
        newly = new_reach & (reach == 0)
        dist = jnp.where(newly, k, dist).astype(jnp.uint16)
        return dist, (new_reach | (reach > 0)).astype(jnp.float32)

    dist, _ = jax.lax.fori_loop(2, max_depth + 1, body, (dist, reach))
    return dist
