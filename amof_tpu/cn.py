"""
Cutoff coordination numbers on device.

API parity with amof/cn.py: ``CoordinationNumber.from_trajectory(traj,
nb_set_and_cutoff, delta_Step, first_frame, parallel)`` :35, per-frame
mean CN per pair spec in a DataFrame indexed by Step :48-82, '.cn'
feather round-trip :84-100.

The ASE neighbor-list search (92% of the reference's CN runtime,
amof/cn.py:65) is replaced by the fused pair engine: one tiled
minimum-image pass per frame counting, for every ordered species pair
(a, b), the pairs with d < cutoff(a, b). The ``parallel`` argument is
accepted for API compatibility; frames are always data-parallel on
device.
"""

from __future__ import annotations

import functools
import logging

import jax
import numpy as np
import pandas as pd

import amof_tpu.files.path
import amof_tpu.trajectory
from amof_tpu import engines, species as amspecies
from amof_tpu.core.frames import as_frame_batch
from amof_tpu.data import elements
from amof_tpu.ops import pair_engine

logger = logging.getLogger(__name__)


@functools.partial(jax.jit, static_argnames=("n_species", "chunk"))
def _trajectory_cn_counts(positions, cells, species_idx, cutoff_matrix,
                          n_species, chunk):
    """One jitted program for the whole trajectory."""
    def one(args):
        pos, cell = args
        return pair_engine.frame_cn_counts(
            pos, cell, species_idx, cutoff_matrix, n_species, chunk
        )

    return jax.lax.map(one, (positions, cells))


@functools.partial(
    jax.jit, static_argnames=("n_species", "chunk", "window")
)
def _trajectory_cn_counts_windowed(positions, cells, species_idx,
                                   cutoff_matrix, n_species, chunk, window):
    def one(args):
        return pair_engine.frame_cn_counts_windowed(
            args[0], args[1], species_idx, cutoff_matrix, n_species,
            chunk, window,
        )

    return jax.lax.map(one, (positions, cells))


class CoordinationNumber:
    """Mean coordination number per frame and pair spec."""

    def __init__(self):
        self.data = pd.DataFrame({"Step": np.empty([0])})

    @classmethod
    def from_trajectory(
        cls, trajectory, nb_set_and_cutoff, delta_Step=1, first_frame=0,
        parallel=False,
    ):
        """Args:
            nb_set_and_cutoff: dict, keys 'A-B' pair strings, values
                cutoffs in Å.
        """
        cn_class = cls()
        batch = as_frame_batch(trajectory)
        step = amof_tpu.trajectory.construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=batch.num_frames,
        )
        cn_class.compute_cn(batch, nb_set_and_cutoff, step, parallel)
        return cn_class

    def compute_cn(self, batch, nb_set_and_cutoff, step, parallel=False):
        del parallel
        species = np.asarray(batch.species)
        unique, z_to_idx = amspecies.species_table(species)
        n_species = len(unique)
        logger.info(
            "Start computing coordination number for %s frames", batch.num_frames
        )
        cutoff_matrix = amspecies.cutoff_matrix(
            nb_set_and_cutoff, unique, z_to_idx
        )
        positions, species_idx = pair_engine.pad_atoms(
            np.asarray(batch.positions), z_to_idx[species]
        )
        chunk = pair_engine._pick_chunk(positions.shape[1])
        cells = np.asarray(batch.cell)

        # sorted-window pass (O(N*W)) when the backend's engine is the
        # window and the cutoffs are small next to the box; exact
        # per-frame miss flags fall back to the O(N^2) pass
        window = None
        if (engines.for_backend().cn_table == "window"
                and positions.shape[1] >= 2048):
            window = pair_engine.auto_window(
                cells, float(cutoff_matrix.max()), positions.shape[1],
                chunk,
            )

        if window is not None:
            cn_w, missed = _trajectory_cn_counts_windowed(
                positions, cells, species_idx, cutoff_matrix, n_species,
                chunk, window,
            )
            # np.array (not asarray): numpy views of JAX arrays are
            # read-only, and missed frames are patched in place below
            counts = np.array(cn_w)
            missed = np.asarray(missed)
            for f in np.nonzero(missed)[0]:
                counts[f] = np.asarray(pair_engine.frame_cn_counts(
                    positions[f], cells[f], species_idx, cutoff_matrix,
                    n_species, chunk,
                ))
        else:
            counts = np.asarray(_trajectory_cn_counts(
                positions, cells, species_idx, cutoff_matrix, n_species,
                chunk,
            ))

        n_per_species = np.array(
            [(species == z).sum() for z in unique], dtype=np.float64
        )
        data = {"Step": step}
        for nb_set in nb_set_and_cutoff:
            a, b = (elements.atomic_numbers[s] for s in nb_set.split("-"))
            ia, ib = int(z_to_idx[a]), int(z_to_idx[b])
            with np.errstate(invalid="ignore"):
                data[nb_set] = counts[:, ia, ib] / n_per_species[ia]
        self.data = pd.DataFrame(data)

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
