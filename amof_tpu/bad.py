"""
Bond-Angle Distributions on device.

API parity with amof/bad.py: ``Bad.from_trajectory(traj,
nb_set_and_cutoff, dtheta=0.05, normalization='total', parallel)`` :39,
the B-A-B triplet semantics of ``bad_BAB`` :71-101 (neighbors under the
full cutoff set, outer atoms filtered by species, every unordered pair of
outer neighbors, minimum-image angles), the wildcard "X" pair enumeration
:122-133, the binning ``bins = int(180 // dtheta)``,
``theta = arange(bins+1)*dtheta + dtheta/2`` :142-144, density
normalization over all frames :154-160, and '.bad' feather round-trip.
``BadByCn`` resolves the BAD per coordination number into a labeled
(atom_triple x cn x theta) array with 'total'/'partial' normalization
(amof/bad.py:172-309), serialized as netCDF.

The per-frame Python loops are replaced by the fused neighbor-table +
angle-histogram kernel (amof_tpu/ops/bad_kernel.py); neighbor capacity
overflow triggers automatic retry with doubled capacity instead of
silent truncation.
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd

import amof_tpu.files.path
from amof_tpu import engines, labeled, species as amspecies
from amof_tpu.core.frames import as_frame_batch
from amof_tpu.ops import bad_kernel, pair_engine

logger = logging.getLogger(__name__)

_MAX_NEIGHBOR_CAPACITY = 512


def _compute_counts(batch, nb_set_and_cutoff, dtheta, by_cn=False):
    """Shared device path: accumulated angle counts
    [n_specs, cn_slots, bins+1] over all frames, plus metadata.
    cn_slots == 1 unless by_cn (the BadByCn axis)."""
    species = np.asarray(batch.species)
    unique, z_to_idx = amspecies.species_table(species)
    cutoff_matrix = amspecies.cutoff_matrix(
        nb_set_and_cutoff, unique, z_to_idx
    )
    pairs, names = amspecies.bad_specs(nb_set_and_cutoff, unique)
    specs = tuple(
        (
            -1 if a == "X" else int(z_to_idx[a]),
            -1 if b == "X" else int(z_to_idx[b]),
        )
        for a, b in pairs
    )
    bins_ref = int(180 // dtheta)
    n_hist_bins = bins_ref + 1
    theta = np.arange(bins_ref + 1) * dtheta + dtheta / 2

    positions, species_idx = pair_engine.pad_atoms(
        np.asarray(batch.positions), z_to_idx[species]
    )
    chunk = pair_engine._pick_chunk(positions.shape[1])
    cells = np.asarray(batch.cell)
    n_species = len(unique)

    # sorted-window neighbor table when the backend's engine is the
    # window and the cutoffs are small next to the box; a window miss
    # sets the overflow flag, and the retry loop below then falls back
    # to the full table
    window = None
    if (engines.for_backend().bad_table == "window"
            and positions.shape[1] >= 2048):
        window = pair_engine.auto_window(
            cells, float(cutoff_matrix.max()), positions.shape[1], chunk
        )

    max_neighbors = 16
    while True:
        conc, center_any, overflow = bad_kernel.trajectory_bad_counts(
            positions, cells, species_idx, cutoff_matrix, n_species,
            float(dtheta), n_hist_bins, max_neighbors, chunk, by_cn=by_cn,
            window=window,
        )
        if not bool(overflow):
            break
        if window is not None:
            # could be a window miss rather than capacity: drop the
            # window first, then grow capacity
            window = None
            continue
        max_neighbors *= 2
        if max_neighbors > _MAX_NEIGHBOR_CAPACITY:
            raise RuntimeError(
                "neighbor capacity exceeded; cutoffs likely unphysical"
            )
        logger.info(
            "neighbor capacity overflow; retrying with max_neighbors=%s",
            max_neighbors,
        )
    conc = np.asarray(conc, dtype=np.float64)
    center_any = np.asarray(center_any, dtype=np.float64)
    counts = np.stack(
        [bad_kernel.select_spec_counts(conc, center_any, s) for s in specs]
    )
    return counts, names, theta


class CoreBad:
    """Shared constructors (parity: amof/bad.py:33-59)."""

    @classmethod
    def from_trajectory(
        cls, trajectory, nb_set_and_cutoff, dtheta=0.05,
        normalization="total", parallel=False,
    ):
        """Args:
            nb_set_and_cutoff: dict, 'A-B' pair strings -> cutoff in Å.
            dtheta: bin width in degrees (0.05 default, as RINGS).
            normalization: 'total' or 'partial' (BadByCn only).
        """
        bad_class = cls()
        bad_class.compute_bad(
            trajectory, nb_set_and_cutoff, dtheta, normalization, parallel
        )
        return bad_class

    @classmethod
    def from_file(cls, filename):
        bad_class = cls()
        bad_class.read_bad_file(filename)
        return bad_class

    @staticmethod
    def bad_BAB(atom, A, B, nl):
        """B-A-B angles of one frame from a per-atom neighbor-list dict
        (parity: amof/bad.py:71-101). Host-side compatibility helper —
        the analysis path uses the fused device kernels instead.

        Args:
            atom: a Frame (or ASE-compatible) object.
            A, B: atomic numbers, or "X" wildcards.
            nl: {atom index: [neighbor indices]} as from
                amof_tpu.atom.get_neighborlist.
        """
        import itertools

        numbers = atom.get_atomic_numbers()
        angles = []
        for a in range(len(numbers)):
            if A == "X" or numbers[a] == A:
                b_nb = [
                    i for i in nl[a] if B == "X" or numbers[i] == B
                ]
                angle_idx = [
                    [i, a, j] for i, j in itertools.combinations(b_nb, 2)
                ]
                if angle_idx:
                    angles += list(atom.get_angles(angle_idx, mic=True))
        return angles


class Bad(CoreBad):
    """Bond-angle distribution, density-normalized over all frames."""

    def __init__(self):
        self.data = pd.DataFrame({"theta": np.empty([0])})

    def compute_bad(self, trajectory, nb_set_and_cutoff, dtheta=0.05,
                    normalization="total", parallel=False):
        del normalization, parallel  # parity args; 'total' is the only mode
        batch = as_frame_batch(trajectory)
        logger.info(
            "Start computing bad for %s frames with dtheta = %s",
            batch.num_frames, dtheta,
        )
        counts, names, theta = _compute_counts(batch, nb_set_and_cutoff, dtheta)
        self.data = pd.DataFrame({"theta": theta})
        angle_counts = counts.sum(axis=1)  # sum over cn axis -> [spec, bins]
        for s, name in enumerate(names):
            total = angle_counts[s].sum()
            if total > 0:
                self.data[name] = angle_counts[s] / (total * dtheta)

    def write_to_file(self, filename):
        filename = amof_tpu.files.path.append_suffix(filename, "bad")
        self.data.to_feather(filename)

    def read_bad_file(self, path_to_data):
        path_to_data = amof_tpu.files.path.append_suffix(path_to_data, "bad")
        self.data = pd.read_feather(path_to_data)


class BadByCn(CoreBad):
    """BAD resolved by coordination number (labeled
    atom_triple x cn x theta array; parity: amof/bad.py:172-309)."""

    def __init__(self):
        self.data = labeled.Dataset()

    def compute_bad(self, trajectory, nb_set_and_cutoff, dtheta=0.05,
                    normalization="total", parallel=False):
        del parallel
        batch = as_frame_batch(trajectory)
        logger.info(
            "Start computing bad by cn for %s frames with dtheta = %s",
            batch.num_frames, dtheta,
        )
        counts, names, theta = _compute_counts(
            batch, nb_set_and_cutoff, dtheta, by_cn=True
        )
        # counts: [spec, cn(K+1), bins]
        per_spec = []
        kept_names = []
        for s, name in enumerate(names):
            cn_totals = counts[s].sum(axis=1)  # [K+1]
            cn_values = np.nonzero(cn_totals > 0)[0]
            if len(cn_values) == 0:
                continue
            num_angles_all = cn_totals.sum()
            rows = []
            for cn in cn_values:
                ratio = (
                    cn_totals[cn] / num_angles_all
                    if normalization == "partial"
                    else 1.0
                )
                rows.append(ratio * counts[s, cn] / (cn_totals[cn] * dtheta))
            per_spec.append(
                labeled.DataArray(
                    np.array(rows),
                    coords={"cn": cn_values.astype(np.int64), "theta": theta},
                    dims=("cn", "theta"),
                )
            )
            kept_names.append(name)
        if per_spec:
            arr = labeled.concat(
                per_spec, "atom_triple", labels=np.array(kept_names), fill=np.nan
            )
            self.data = labeled.Dataset({"bad": arr.rename("bad")})
        else:
            self.data = labeled.Dataset()

    def write_to_file(self, filename):
        filename = amof_tpu.files.path.append_suffix(filename, "bad")
        self.data.to_netcdf(filename)

    def read_bad_file(self, filename):
        filename = amof_tpu.files.path.append_suffix(filename, "bad")
        self.data = labeled.open_dataset(filename)
