"""
amof_tpu — a JAX framework for analyzing Molecular Dynamics
trajectories of amorphous Metal-Organic Frameworks on an accelerator.

Trajectories are device-resident array batches, the per-frame pair loop
is a fused on-device engine shared by RDF / CN / BAD, MSD runs as FFT
autocorrelation, pore analysis is a probe-insertion grid + flood fill,
and ring statistics run as bounded graph search (device distance
matrices + a C++ host enumerator).

Capability parity target: coudertlab/amof v1.1.0 (see SURVEY.md). Public
API mirrors the reference's uniform contract — every analysis class is
built via ``from_trajectory`` / ``from_file``, stores results in ``.data``
and serializes with suffix-enforcing ``write_to_file``
(parity: amof/rdf.py:38-122, amof/files/path.py:7-22).
"""

__version__ = "0.1.0"

from amof_tpu.cache import enable_persistent_cache
from amof_tpu.core.frames import Frame, FrameBatch, Trajectory, as_frame_batch

# persist compiled executables across processes
enable_persistent_cache()

__all__ = [
    "Frame",
    "FrameBatch",
    "Trajectory",
    "as_frame_batch",
    "enable_persistent_cache",
    "__version__",
]
