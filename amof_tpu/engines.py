"""
The one place that decides which engine each pair analysis runs on
each backend. Every caller (the analysis classes, ``FusedAnalysis``,
the benchmark) asks ``for_backend``; none tests the backend itself.

Choices:

* ``bad_table`` — the BAD neighbor table: ``"window"`` (the sorted
  one-level window table, O(N*W), with the window -> full-table retry
  ladder) or ``"full"`` (the O(N^2) table).
* ``cn_table`` — CN counts: ``"window"`` (counts from the sorted-window
  pass, full pass only for frames whose window check fails) or
  ``"full"`` (the tiled O(N^2) pass).

The GPU entries are what an H100 measured at the 10240-atom glass
widths (``scripts/profile_fused_stages.py``; both timings of each
choice are in PERF.md). The RDF histogram is not a choice:
scatter-add is faster than a one-hot matrix product on both backends.
"""

from __future__ import annotations

from typing import NamedTuple

import jax


class Engines(NamedTuple):
    bad_table: str
    cn_table: str


_BY_BACKEND = {
    "cpu": Engines(bad_table="window", cn_table="window"),
    "gpu": Engines(bad_table="window", cn_table="window"),
}


def for_backend(backend: str | None = None) -> Engines:
    """Engine choices for ``backend`` (default: ``jax.default_backend()``).

    A backend without an entry is an error: no engine is guessed for a
    machine nobody measured."""
    backend = backend or jax.default_backend()
    try:
        return _BY_BACKEND[backend]
    except KeyError:
        raise ValueError(
            f"no engine table for backend {backend!r}; known: "
            f"{sorted(_BY_BACKEND)}"
        ) from None
