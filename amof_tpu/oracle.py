"""
Plain float64 numpy references for the device engines, and the
tolerance rules that compare a float32 device result with them.

Each reference recomputes one analysis by brute force, independent of
the engine code: every pair by round-based minimum image (exact within
half the minimum cell width, the domain of the device kernels), angles
by ``arccos`` of float64 unit vectors, MSD by direct differences over
every origin. They are chunked over centre atoms so a 10^4-atom frame
fits in a few hundred MB.

The tolerance rules follow from float32 rounding. A float32 distance
under 30 Å is off by less than 4e-6 Å, so only a pair whose float64
distance lies within ``EDGE_EPS`` = 1e-5 Å of a bin edge or cutoff may
fall on the other side of it on the device. A histogram therefore
agrees when, at every edge, the cumulative counts differ by no more
than the number of such pairs (``cumulative_excess``). Angles use the
same rule with ``ANGLE_EPS_DEG`` about each edge, widened near 0 and
180 degrees where ``arccos`` amplifies the rounding of a float32
cosine (``angle_edge_tolerance``).
"""

from __future__ import annotations

import itertools

import numpy as np

EDGE_EPS = 1e-5  # Å about each distance edge or cutoff
ANGLE_EPS_DEG = 1e-3  # degrees about each angle edge
# rounding of a float32 cosine near +-1 (a few ulps): arccos turns it
# into an angle error of COS_EPS / sin(theta)
COS_EPS = 4e-7


def min_image(delta, cell):
    """Round-based minimum image of ``delta`` [..., 3] in float64."""
    cell = np.asarray(cell, np.float64)
    frac = delta @ np.linalg.inv(cell)
    frac -= np.floor(frac + 0.5)
    return frac @ cell


def _row_chunks(n, chunk):
    for i0 in range(0, n, chunk):
        yield i0, min(i0 + chunk, n)


def _deltas(pos, cell, i0, i1):
    """Minimum-image vectors from atoms [i0, i1) to every atom."""
    return min_image(pos[None, :, :] - pos[i0:i1, None, :], cell)


def rdf_counts(positions, cell, species_idx, n_species, dr, bins,
               chunk=256):
    """Ordered-pair distance histogram of one frame.

    Returns (counts, near), both float64:
      counts[a, b, k] = #{(i in a, j in b), i != j, k*dr <= d < (k+1)*dr}
      near[a, b, e]   = #{(i in a, j in b), i != j, |d - e*dr| < EDGE_EPS}
    for edges e = 0..bins (edge ``bins`` is the cutoff rmax).
    Atoms with species -1 (padding) are ignored.
    """
    pos = np.asarray(positions, np.float64)
    sp = np.asarray(species_idx)
    n = len(pos)
    s = n_species
    counts = np.zeros(s * s * bins)
    near = np.zeros(s * s * (bins + 1))
    for i0, i1 in _row_chunks(n, chunk):
        d = np.linalg.norm(_deltas(pos, cell, i0, i1), axis=-1)
        si = sp[i0:i1, None]
        live = (si >= 0) & (sp[None, :] >= 0)
        live &= np.arange(i0, i1)[:, None] != np.arange(n)[None, :]
        pair = si * s + sp[None, :]
        b = np.floor(d / dr).astype(np.int64)
        ok = live & (b < bins)
        counts += np.bincount(
            (pair * bins + b)[ok], minlength=s * s * bins
        )
        e = np.rint(d / dr).astype(np.int64)
        ok = live & (e <= bins) & (np.abs(d - e * dr) < EDGE_EPS)
        near += np.bincount(
            (pair * (bins + 1) + e)[ok], minlength=s * s * (bins + 1)
        )
    return counts.reshape(s, s, bins), near.reshape(s, s, bins + 1)


def neighbor_pairs(positions, cell, species_idx, cutoff_matrix, chunk=256):
    """Every ordered pair (i, j), i != j, with d_ij < cutoff(s_i, s_j)
    + EDGE_EPS (cutoff 0 disables a species pair).

    Returns (i, j, vec [P, 3], d [P], uncertain [P]): ``uncertain``
    marks pairs within EDGE_EPS of their cutoff, whose membership a
    float32 engine may decide either way."""
    pos = np.asarray(positions, np.float64)
    sp = np.asarray(species_idx)
    cm = np.asarray(cutoff_matrix, np.float64)
    n = len(pos)
    out = [[], [], [], [], []]
    for i0, i1 in _row_chunks(n, chunk):
        vec = _deltas(pos, cell, i0, i1)
        d = np.linalg.norm(vec, axis=-1)
        si = sp[i0:i1, None]
        live = (si >= 0) & (sp[None, :] >= 0)
        live &= np.arange(i0, i1)[:, None] != np.arange(n)[None, :]
        cut = cm[np.maximum(si, 0), np.maximum(sp[None, :], 0)]
        hit = live & (cut > 0) & (d < cut + EDGE_EPS)
        ii, jj = np.nonzero(hit)
        out[0].append(ii + i0)
        out[1].append(jj)
        out[2].append(vec[ii, jj])
        out[3].append(d[ii, jj])
        out[4].append(np.abs(d[ii, jj] - cut[ii, jj]) < EDGE_EPS)
    return tuple(np.concatenate(o) for o in out)


def cn_counts(positions, cell, species_idx, cutoff_matrix, n_species):
    """Ordered-pair neighbor counts under a cutoff matrix.

    Returns (counts [S, S], near [S, S]): ``near`` counts the pairs
    within EDGE_EPS of their cutoff (in ``counts`` only when below it).
    """
    i, j, _, d, unc = neighbor_pairs(
        positions, cell, species_idx, cutoff_matrix
    )
    sp = np.asarray(species_idx)
    cm = np.asarray(cutoff_matrix, np.float64)
    key = sp[i] * n_species + sp[j]
    inside = d < cm[sp[i], sp[j]]
    s2 = n_species * n_species
    counts = np.bincount(key[inside], minlength=s2)
    near = np.bincount(key[unc], minlength=s2)
    return (counts.reshape(n_species, n_species).astype(np.float64),
            near.reshape(n_species, n_species).astype(np.float64))


def angle_edge_tolerance(theta_deg):
    """Half-width (degrees) of the band about an edge inside which a
    float32 engine may bin an angle ``theta_deg`` on either side."""
    s = np.maximum(np.sin(np.radians(theta_deg)), 1e-6)
    return ANGLE_EPS_DEG + np.degrees(COS_EPS / s)


def bad_counts(positions, cell, species_idx, cutoff_matrix, n_species,
               dtheta, bins):
    """B-A-B angle histograms of one frame (the device's by_cn=False
    layout): every unordered pair of neighbors of a centre, neighbors
    under the full cutoff matrix.

    Returns (concrete [S, S, bins], center_any [S, bins],
    near_c [S, S, bins + 1], near_a [S, bins + 1],
    loose_c [S, S], loose_a [S]):
      concrete[a, b]  angles at centres of species a whose two outer
                      atoms are both of species b;
      center_any[a]   all angles at centres of species a;
      near_*[.., e]   angles within ``angle_edge_tolerance`` of edge e;
      loose_*         angles with a neighbor within EDGE_EPS of its
                      cutoff (counted in no histogram: the device may
                      count them anywhere, so they loosen every edge).
    Angles use bin min(floor(theta / dtheta), bins - 1).
    """
    i, j, vec, d, unc = neighbor_pairs(
        positions, cell, species_idx, cutoff_matrix
    )
    sp = np.asarray(species_idx)
    s = n_species
    concrete = np.zeros((s, s, bins))
    center_any = np.zeros((s, bins))
    near_c = np.zeros((s, s, bins + 1))
    near_a = np.zeros((s, bins + 1))
    loose_c = np.zeros((s, s))
    loose_a = np.zeros(s)
    unit = vec / d[:, None]
    order = np.argsort(i, kind="stable")
    i, j, unit, unc = i[order], j[order], unit[order], unc[order]
    centres, start, count = np.unique(i, return_index=True,
                                      return_counts=True)
    for k in np.unique(count):
        if k < 2:
            continue
        rows = start[count == k][:, None] + np.arange(k)[None, :]
        ctr_sp = sp[centres[count == k]]
        a_idx, b_idx = np.array(list(itertools.combinations(range(k), 2))).T
        u1, u2 = unit[rows[:, a_idx]], unit[rows[:, b_idx]]
        theta = np.degrees(np.arccos(np.clip(
            np.sum(u1 * u2, axis=-1), -1.0, 1.0
        )))
        s1, s2 = sp[j[rows[:, a_idx]]], sp[j[rows[:, b_idx]]]
        loose = unc[rows[:, a_idx]] | unc[rows[:, b_idx]]
        a_sp = np.broadcast_to(ctr_sp[:, None], theta.shape)
        same = s1 == s2
        tbin = np.minimum(np.floor(theta / dtheta).astype(np.int64),
                          bins - 1)
        e = np.rint(theta / dtheta).astype(np.int64)
        is_near = np.abs(theta - e * dtheta) < angle_edge_tolerance(theta)
        sure = ~loose
        np.add.at(center_any, (a_sp[sure], tbin[sure]), 1)
        np.add.at(near_a, (a_sp[sure & is_near], e[sure & is_near]), 1)
        np.add.at(loose_a, a_sp[loose], 1)
        m = sure & same
        np.add.at(concrete, (a_sp[m], s1[m], tbin[m]), 1)
        m = m & is_near
        np.add.at(near_c, (a_sp[m], s1[m], e[m]), 1)
        m = loose & same
        np.add.at(loose_c, (a_sp[m], s1[m]), 1)
    return concrete, center_any, near_c, near_a, loose_c, loose_a


def cumulative_excess(dev, ref, near, loose=0.0):
    """Largest amount by which a device histogram breaks the edge rule.

    ``dev``, ``ref``: [..., bins] histograms; ``near``: [..., bins + 1]
    counts of reference entries near each edge; ``loose``: [...]
    entries that may land anywhere. At every edge e = 1..bins the
    cumulative counts may differ by near[e] + loose. Returns the
    largest |C_dev - C_ref| - allowance over all edges: the histograms
    agree when it is <= 0.
    """
    dev = np.asarray(dev, np.float64)
    ref = np.asarray(ref, np.float64)
    diff = np.abs(np.cumsum(dev, axis=-1) - np.cumsum(ref, axis=-1))
    allow = np.asarray(near)[..., 1:] + np.asarray(loose)[..., None]
    return float(np.max(diff - allow))


def windowed_msd(positions, cells, masses, species_idx, n_species):
    """Direct MSD over every origin, in float64, with the reference's
    estimator (amof/msd.py:186-205: the k=0 origin is skipped, the
    divisor is T - m) and order (amof/msd.py:235-247: mass-weighted COM
    removed from the stored positions, then minimum-image consecutive
    displacements summed).

    Returns (msd [T], msd_species [T, S]); MSD(0) = 0.
    """
    pos = np.asarray(positions, np.float64)
    cells = np.asarray(cells, np.float64)
    m = np.asarray(masses, np.float64)
    sp = np.asarray(species_idx)
    t = len(pos)
    com = np.einsum("tai,a->ti", pos, m) / m.sum()
    x = pos - com[:, None, :]
    steps = np.stack([
        min_image(x[k + 1] - x[k], cells[k]) for k in range(t - 1)
    ])
    r = np.concatenate([x[:1], x[:1] + np.cumsum(steps, axis=0)])
    per_atom = np.zeros((t, len(m)))
    for lag in range(1, t):
        dsq = np.sum((r[lag + 1:] - r[1:t - lag]) ** 2, axis=-1)
        per_atom[lag] = dsq.sum(axis=0) / (t - lag)
    live = sp >= 0
    msd = per_atom[:, live].mean(axis=1)
    msd_sp = np.stack([
        per_atom[:, sp == k].mean(axis=1) for k in range(n_species)
    ], axis=1)
    return msd, msd_sp
