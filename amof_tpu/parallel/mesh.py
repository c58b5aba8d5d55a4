"""
Device-mesh construction for trajectory analysis.

The reference's only parallelism is joblib process pools over frames
(SURVEY.md §2 row 20). The device equivalent is a single SPMD
program over a 2-d mesh:

  * axis 'frames' — pure data parallelism over the trajectory (the
    joblib-over-frames pattern done properly); histogram partials
    psum-merge over this axis;
  * axis 'atoms'  — shards the i-atom range of the O(N^2) pair loop
    (and the atom axis of the MSD FFT), the analog of tensor/sequence
    parallelism for this workload.

Pipeline and expert parallelism have no analog here: the analyses are
single-pass reductions with no layer pipeline and no routed experts —
stated explicitly per SURVEY.md §5.7 rather than invented.

Collectives are plain psum/all_gather over mesh axes, which XLA hands
to the device interconnect (NCCL over NVLink on GPUs). The mesh
follows the algorithm alone: every device reaches every other at the
same rate.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def analysis_mesh(n_devices=None, frames_axis=None, n_frames=None) -> Mesh:
    """Build a ('frames', 'atoms') mesh over the available devices.

    The 'frames' axis gets every device by default (frame parallelism
    has zero communication until the final psum). When ``n_frames`` is
    given and is not divisible by the device count, the 'frames' axis
    shrinks to the largest divisor of the device count that divides
    ``n_frames`` and the remaining devices shard the atom axis — so any
    frame count runs on any device count.

    Args:
        n_devices: number of devices (default: all available).
        frames_axis: explicit size of the 'frames' axis; must divide
            the device count. Overrides the ``n_frames`` heuristic.
        n_frames: number of trajectory frames the mesh will shard;
            used to auto-split frames/atoms as described above.
    """
    devices = jax.devices()
    n_avail = len(devices)
    if n_devices is not None:
        if n_devices > n_avail:
            raise ValueError(
                f"requested {n_devices} devices, but only {n_avail} "
                f"available (platform={devices[0].platform!r}); for a "
                f"virtual CPU mesh set JAX_PLATFORMS=cpu and XLA_FLAGS="
                f"--xla_force_host_platform_device_count={n_devices}"
            )
        devices = devices[:n_devices]
    n = len(devices)
    if frames_axis is None:
        frames_axis = n
        if n_frames is not None and n_frames > 0:
            while n % frames_axis or n_frames % frames_axis:
                frames_axis -= 1
    if frames_axis < 1 or n % frames_axis:
        raise ValueError(
            f"frames_axis={frames_axis} must be a positive divisor of "
            f"the device count ({n})"
        )
    atoms_axis = n // frames_axis
    dev_array = np.array(devices).reshape(frames_axis, atoms_axis)
    return Mesh(dev_array, ("frames", "atoms"))


def divisible_pad(n: int, parts: int) -> int:
    """Amount of padding to make n divisible by parts."""
    return (-n) % parts
