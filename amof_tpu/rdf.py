"""
Radial Distribution Functions on device.

API parity with amof/rdf.py: ``Rdf`` (:28) with
``from_trajectory(traj, dr=0.01, rmax='half_cell')`` :38,
``from_file``/``write_to_file`` with the '.rdf' feather suffix :116-122,
the same output columns ("r", "X-X", every ordered "A-B" partial, "A-X"
row sums :96-114), the ``rmax='half_cell'`` rule :74-79 and the
``bins = int(rmax // dr)``, ``r = arange(bins)*dr`` binning :82-83.
The deprecated RDF-integral ``CoordinationNumber`` (:135) and
``get_coordination_number`` = 4 pi rho Simpson-integral (:216-227) and
``RdfPlotter`` (:230) are provided too.

The asap3 C++ accumulation loop is replaced by the fused on-device pair
engine (one tiled minimum-image distance + histogram pass per frame,
vmapped over the trajectory — amof_tpu/ops/pair_engine.py).

Normalization convention (asap3-compatible):
    g_AB(r_k) = C_AB(k) * V / (F * N_A * N_tot * v_shell(k))
with C_AB the ordered pair count, v_shell the exact shell volume
4 pi/3 ((r+dr)^3 - r^3), and the global number density N_tot/V — the
convention under which 4 pi rho_tot Int g_AB r^2 dr = CN_AB, exactly how
the reference consumes these partials (amof/rdf.py:216-227). For NPT
trajectories each frame is normalized with its own volume.
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import scipy.integrate

import amof_tpu.files.path
import amof_tpu.trajectory
from amof_tpu.core.frames import as_frame_batch
from amof_tpu.data import elements
from amof_tpu.ops import pair_engine
from amof_tpu.species import species_table

logger = logging.getLogger(__name__)


def shell_volumes(bins: int, dr: float) -> np.ndarray:
    """Exact spherical shell volumes 4pi/3((r+dr)^3 - r^3)."""
    edges = np.arange(bins + 1) * dr
    return 4.0 * np.pi / 3.0 * (edges[1:] ** 3 - edges[:-1] ** 3)


class Rdf:
    """Total + all-pairs partial g(r) over a trajectory."""

    def __init__(self):
        self.data = pd.DataFrame({"r": np.empty([0])})

    @classmethod
    def from_trajectory(cls, trajectory, dr=0.01, rmax="half_cell"):
        """Compute the RDF of a trajectory.

        Args:
            trajectory: Trajectory / list of Frames / FrameBatch.
            dr: bin width in Å.
            rmax: float in Å or 'half_cell' (half the minimum cell length
                over all frames; larger values are clamped to it).
        """
        rdf_class = cls()
        rdf_class.compute_rdf(trajectory, dr, rmax)
        return rdf_class

    @classmethod
    def from_rdf(cls, *args):
        logger.exception("from_rdf is deprecated, use from_file instead")

    @classmethod
    def from_file(cls, path_to_rdf):
        rdf_class = cls()
        rdf_class.read_rdf_file(path_to_rdf)
        return rdf_class

    def compute_rdf(self, trajectory, dr, rmax):
        batch = as_frame_batch(trajectory)
        species = np.asarray(batch.species)
        unique, z_to_idx = species_table(species)
        n_species = len(unique)
        n_atoms = batch.num_atoms
        n_frames = batch.num_frames

        cells = np.asarray(batch.cell, dtype=np.float64)
        lengths = np.linalg.norm(cells, axis=2)  # [F, 3]
        rmax_half_cell = float(lengths.min()) / 2
        if rmax == "half_cell":
            rmax = rmax_half_cell
        elif rmax > rmax_half_cell:
            logger.info(
                "Specified rmax %s is larger than half cell; will use half_cell rmax",
                rmax,
            )
            rmax = rmax_half_cell

        logger.info(
            "Start computing rdf for %s frames with dr = %s and rmax = %s",
            n_frames, dr, rmax,
        )
        bins = int(rmax // dr)
        r = np.arange(bins) * dr
        self.data = pd.DataFrame({"r": r})

        volumes = np.abs(np.linalg.det(cells)).astype(np.float32)
        positions, species_idx = pair_engine.pad_atoms(
            np.asarray(batch.positions), z_to_idx[species]
        )
        counts = np.asarray(
            pair_engine.trajectory_rdf_counts(
                positions,
                np.asarray(batch.cell),
                species_idx,
                float(dr),
                n_species,
                bins,
                frame_weights=volumes,
            ),
            dtype=np.float64,
        )  # volume-weighted counts [S, S, bins]

        v_shell = shell_volumes(bins, dr)
        n_per_species = np.array([(species == z).sum() for z in unique], dtype=np.float64)

        # Total X-X: all pairs, normalized with N_sel = N_tot
        total_counts = counts.sum(axis=(0, 1))
        self.data["X-X"] = total_counts / (n_frames * n_atoms * n_atoms * v_shell)

        # Partials A-B (every ordered pair), then A-X row sums
        partial = {}
        for i, za in enumerate(unique):
            for j, zb in enumerate(unique):
                name = f"{elements.symbol_of(za)}-{elements.symbol_of(zb)}"
                g = counts[i, j] / (n_frames * n_per_species[i] * n_atoms * v_shell)
                partial[(i, j)] = g
                self.data[name] = g
        for i, za in enumerate(unique):
            self.data[f"{elements.symbol_of(za)}-X"] = sum(
                partial[(i, j)] for j in range(n_species)
            )

    def write_to_file(self, filename):
        filename = amof_tpu.files.path.append_suffix(filename, "rdf")
        self.data.to_feather(filename)

    def read_rdf_file(self, path_to_data):
        path_to_data = amof_tpu.files.path.append_suffix(path_to_data, "rdf")
        self.data = pd.read_feather(path_to_data)

    def get_coordination_number(self, nn_set, cutoff, density):
        """RDF-integral coordination number for pair column ``nn_set``."""
        return get_coordination_number(
            self.data["r"], self.data[nn_set], cutoff, density
        )


class CoordinationNumber:
    """Coordination number from per-frame RDF integration.

    Deprecated path kept for API parity (amof/rdf.py:135-214) — subject to
    integration error; prefer ``amof_tpu.cn.CoordinationNumber``.
    """

    def __init__(self):
        logger.warning(
            "Compute CoordinationNumber from RDF, best to use amof_tpu.cn.CoordinationNumber"
        )
        self.data = pd.DataFrame({"Step": np.empty([0])})

    @classmethod
    def from_trajectory(
        cls, trajectory, nb_set_and_cutoff, delta_Step=1, first_frame=0,
        dr=0.0001, parallel=False,
    ):
        cn_class = cls()
        batch = as_frame_batch(trajectory)
        step = amof_tpu.trajectory.construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=batch.num_frames,
        )
        cn_class.compute_cn(batch, nb_set_and_cutoff, step, dr, parallel)
        return cn_class

    def compute_cn(self, batch, nb_set_and_cutoff, step, dr, parallel):
        del parallel  # the device engine is always data-parallel over frames
        species = np.asarray(batch.species)
        unique, z_to_idx = species_table(species)
        n_species = len(unique)
        n_atoms = batch.num_atoms

        rmax = float(np.max(list(nb_set_and_cutoff.values())))
        bins = int(rmax // dr)
        r = np.arange(bins) * dr
        v_shell = shell_volumes(bins, dr)
        n_per_species = np.array([(species == z).sum() for z in unique], dtype=np.float64)

        positions, species_idx = pair_engine.pad_atoms(
            np.asarray(batch.positions), z_to_idx[species]
        )
        cells = np.asarray(batch.cell, dtype=np.float64)
        volumes = np.abs(np.linalg.det(cells))

        list_of_dict = []
        for f in range(batch.num_frames):
            counts = np.asarray(
                pair_engine.frame_rdf_counts(
                    positions[f], np.asarray(batch.cell)[f], species_idx,
                    float(dr), n_species, bins,
                    chunk=pair_engine._pick_chunk(positions.shape[1]),
                ),
                dtype=np.float64,
            )
            density = n_atoms / volumes[f]
            dic = {"Step": step[f]}
            for nn_set in nb_set_and_cutoff:
                a, b = (elements.atomic_numbers[s] for s in nn_set.split("-"))
                i, j = int(z_to_idx[a]), int(z_to_idx[b])
                g = counts[i, j] / (n_per_species[i] * n_atoms / volumes[f] * v_shell)
                dic[nn_set] = get_coordination_number(
                    r, g, nb_set_and_cutoff[nn_set], density
                )
            list_of_dict.append(dic)
        self.data = pd.DataFrame(list_of_dict)

    @classmethod
    def from_file(cls, filename):
        cn_class = cls()
        cn_class.read_cn_file(filename)
        return cn_class

    def read_cn_file(self, filename):
        filename = amof_tpu.files.path.append_suffix(filename, "cn")
        self.data = pd.read_feather(filename)

    def write_to_file(self, filename):
        filename = amof_tpu.files.path.append_suffix(filename, "cn")
        self.data.to_feather(filename)


def get_coordination_number(r, rdf, cutoff, density):
    """CN = 4 pi rho Int_0^cutoff g(r) r^2 dr (Simpson), with the global
    number density — reference convention (amof/rdf.py:216-227)."""
    r = np.asarray(r, dtype=np.float64)
    rdf = np.asarray(rdf, dtype=np.float64)
    mask = (r > 0) & (r < cutoff)
    r = r[mask]
    rdf = rdf[mask]
    integral = scipy.integrate.simpson(rdf * (r**2), x=r)
    return 4 * np.pi * density * integral


class RdfPlotter:
    """Overlay plotting of multiple stored RDFs
    (parity: amof/rdf.py:230-268)."""

    def __init__(self):
        self.multiple_rdf_data = {}

    def add_rdf(self, path_to_rdf, rdf_name=None):
        if rdf_name is None:
            rdf_name = path_to_rdf
        self.multiple_rdf_data[rdf_name] = Rdf.from_file(path_to_rdf).data

    @classmethod
    def from_multiple_rdf(cls, list_of_path_to_rdf, list_of_rdf_name=None):
        if list_of_rdf_name is None:
            list_of_rdf_name = list_of_path_to_rdf
        plotter = cls()
        for path, name in zip(list_of_path_to_rdf, list_of_rdf_name):
            plotter.add_rdf(path, name)
        return plotter

    def plot(self, nn_set, path_to_plot=None, xlim=None):
        import matplotlib.pyplot as plt

        for rdf_name, rdf_data in self.multiple_rdf_data.items():
            plt.plot(rdf_data["r"], rdf_data[nn_set], label=rdf_name,
                     alpha=0.9, linewidth=1)
        plt.legend()
        plt.xlabel(r"$r$ ($\AA$)")
        plt.ylabel("$g(r)$")
        if xlim is not None:
            plt.xlim(xlim[0], xlim[-1])
        plt.title(nn_set)
        if path_to_plot is not None:
            plt.savefig(str(path_to_plot) + ".png", dpi=300)
        plt.show()
