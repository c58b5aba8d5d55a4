"""
Pore analysis over a trajectory.

API parity with amof/pore/core.py: ``Pore.from_trajectory(traj,
delta_Step, first_frame, parallel)`` :33 producing a DataFrame with one
row per frame holding the Zeo++ ``-sa``/``-vol`` output fields (ASA/NASA
in Å^2, m^2/cm^3, m^2/g; AV/NAV in Å^3, volume fraction, cm^3/g —
the fields parsed at :70-82), and the '.pore' feather round-trip
:104-121. Frames whose analysis fails are dropped with a warning, the
analog of the reference's Zeo++-timeout frame drop (:99-101).

The Zeo++ subprocess is replaced by the in-process device analysis in
amof_tpu.pore.zeopp (distance grid + periodic flood fill).
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd

import amof_tpu.files.path
import amof_tpu.trajectory
from amof_tpu.core.frames import as_frames
from amof_tpu.pore import zeopp

logger = logging.getLogger(__name__)


class Pore:
    """Probe-accessible surface and volume per frame."""

    def __init__(self):
        self.data = pd.DataFrame({"Step": np.empty([0])})

    @classmethod
    def from_trajectory(cls, trajectory, delta_Step=1, first_frame=0,
                        parallel=False, **kwargs):
        """kwargs are forwarded to zeopp.analyze_frame (probe_radius,
        chan_radius, num_samples, radii, resolution, ...)."""
        pore_class = cls()
        frames = as_frames(trajectory)
        step = amof_tpu.trajectory.construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=len(frames),
        )
        pore_class.compute_surface_volume(frames, step, parallel, **kwargs)
        return pore_class

    _BATCHABLE_KWARGS = frozenset(
        ("probe_radius", "chan_radius", "num_samples", "radii",
         "resolution", "grid", "window", "winding")
    )

    def compute_surface_volume(self, frames, step, parallel=False, **kwargs):
        # `parallel` is the reference's joblib toggle (amof/pore/core.py:
        # 52-61). For -sa/-vol-only requests the device equivalent —
        # one compiled program mapped over all frames, sharded over the
        # mesh — is strictly better and is the default; `parallel` then
        # only governs the per-frame fallback (non-batchable option
        # sets like psd/chan/ray/block, or batch-path failure), which
        # fans frames out over a host thread pool with the reference's
        # worker heuristic.
        logger.info(
            "Start pore analysis for volume and surfaces for %s frames",
            len(frames),
        )
        if set(kwargs) <= self._BATCHABLE_KWARGS:
            try:
                from amof_tpu.pore.batch import BatchedPore

                records, _ = BatchedPore(**kwargs).run(frames)
                self.data = pd.DataFrame(
                    [{"Step": s, **rec} for s, rec in zip(step, records)]
                )
                return
            except Exception:
                logger.warning(
                    "batched pore path failed; falling back to the "
                    "per-frame path", exc_info=True,
                )
        from amof_tpu.parallel.host import parallel_map

        # the per-frame path always runs the exact displacement-vector
        # winding analysis; `winding` only selects the BATCHED policy
        kwargs.pop("winding", None)
        results = parallel_map(
            lambda args: self.get_surface_volume(
                args[1], step[args[0]], **kwargs
            ),
            list(enumerate(frames)),
            parallel,
            prefer="threads",  # per-frame work is device dispatch +
            #                    host numpy/union-find; both release
            #                    the GIL
        )
        list_of_dict = [d for d in results if d is not None]
        if list_of_dict:
            self.data = pd.DataFrame(list_of_dict)

    @staticmethod
    def read_zeopp(filename):
        """Parse a Zeo++ ``.sa``/``.vol`` output file's first line into
        a {field: value} dict (parity: amof/pore/core.py:70-82) —
        interop for stored outputs of the external binary; the
        in-process path returns such dicts directly."""
        import re

        with open(filename) as f:
            first_line = f.readline().strip("\n")
        tokens = re.split(r" +", first_line.strip())
        tokens = tokens[6:]  # drop file name, density, unit-cell volume
        keys = [t.strip(":") for t in tokens[::2]]
        values = [float(t) for t in tokens[1::2]]
        return dict(zip(keys, values))

    @staticmethod
    def get_surface_volume(frame, step, **kwargs):
        """Analyze one frame; None on failure (frame dropped, parity with
        the reference's timeout handling)."""
        try:
            result = zeopp.analyze_frame(frame, sa=True, vol=True, **kwargs)
        except Exception:
            logger.warning(
                "Pore analysis failed. System size: %s; Step: %s",
                frame.get_global_number_of_atoms(), step, exc_info=True,
            )
            return None
        dic = {"Step": step}
        dic.update(
            {k: v for k, v in result.items() if np.isscalar(v)}
        )
        return dic

    def write_to_file(self, filename):
        filename = amof_tpu.files.path.append_suffix(filename, "pore")
        self.data.to_feather(filename)

    @classmethod
    def from_file(cls, filename):
        pore_class = cls()
        pore_class.read_surface_volume_file(filename)
        return pore_class

    def read_surface_volume_file(self, filename):
        filename = amof_tpu.files.path.append_suffix(filename, "pore")
        self.data = pd.read_feather(filename)
