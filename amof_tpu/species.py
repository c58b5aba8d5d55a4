"""
Species bookkeeping shared by the analysis classes and the fused
engines: dense species indices, per-species-pair cutoff matrices and the
bond-angle spec enumeration. Needs only numpy, so the device engines
(``FusedAnalysis``, ``BatchedPore``) import without pandas.
"""

from __future__ import annotations

import numpy as np

from amof_tpu.atom import format_cutoff
from amof_tpu.data import elements


def species_table(species: np.ndarray):
    """Sorted unique atomic numbers + dense index mapping."""
    unique = np.array(sorted(set(np.asarray(species).tolist())))
    z_to_idx = np.full(int(unique.max()) + 1, -1, dtype=np.int32)
    z_to_idx[unique] = np.arange(len(unique), dtype=np.int32)
    return unique, z_to_idx


def cutoff_matrix(nb_set_and_cutoff, unique, z_to_idx):
    """[S, S] symmetric cutoff matrix over dense species indices."""
    n_species = len(unique)
    mat = np.zeros((n_species, n_species), dtype=np.float32)
    for key, cutoff in format_cutoff(nb_set_and_cutoff).items():
        a, b = key
        ia, ib = int(z_to_idx[a]), int(z_to_idx[b])
        mat[ia, ib] = cutoff
        mat[ib, ia] = cutoff
    return mat


def bad_specs(nb_set_and_cutoff, unique):
    """Wildcard-aware (center, outer) pair enumeration + column names.

    Mirrors amof/bad.py:122-133: "X" is appended iff the cutoff spec
    covers every species present; pairs with identical center and outer
    species are excluded except ("X", "X").
    """
    present = sorted(
        {
            elements.atomic_numbers[s]
            for nb_set in nb_set_and_cutoff
            for s in nb_set.split("-")
        }
    )
    epu: list = list(present)
    if len(epu) == len(unique):
        epu.append("X")
    pairs = [
        (a, b)
        for b in epu
        for a in epu
        if (a not in [b, "X"] or ((a, b) == ("X", "X")))
    ]

    def sym(x):
        return "X" if x == "X" else elements.symbol_of(x)

    names = ["-".join([sym(b), sym(a), sym(b)]) for a, b in pairs]
    return pairs, names
