from amof_tpu.pore.zeopp import network

__all__ = ["Pore", "network"]


def __getattr__(name):
    # Pore (pore.core) needs pandas; the device engines under this
    # package (batch, grid_kernel, zeopp) do not, so import it lazily
    if name == "Pore":
        from amof_tpu.pore.core import Pore

        return Pore
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
