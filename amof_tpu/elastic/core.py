"""
Elastic constants from cell fluctuations + mechanical properties.

API parity with amof/elastic/core.py: ``ElasticConstant.from_cell(h, T,
final_value, step)`` :36 with the strain-fluctuation method —
eps = (h0^-T h^T h h0^-1 - I)/2 per frame :91-118, compliance from
Voigt-strain covariances with cumulative means (running estimate,
``set_every_C`` :120-157) or final values only (``set_final_C``
:159-191), the V/(kB T) factor :122,163, condition-number pruning
:141-144, stiffness C = S^-1 / 1e9 GPa :148, '.elastic' netCDF output;
``MechanicalProperties.from_elastic`` :236 (ELATE averages ->
voigt/reuss/hill DataFrame, '.mech.csv'); ``print_Cmat`` :281-296.

The per-frame Python map/loops are replaced by vectorized float64
numpy. This analysis stays on host deliberately: the covariance
differences (fij - fi*fj) of ~1e-3 strains underflow f32
catastrophically, the arrays are tiny (T x 6 x 6), and accelerators
run f64 far slower than f32 — the trajectory-scale kernels are the
device citizens, not this one.
"""

from __future__ import annotations

import logging
import sys

import numpy as np
import pandas as pd

import amof_tpu.files.path as ampath
from amof_tpu import labeled
from amof_tpu.core import cellmath
from amof_tpu.elastic import elate

logger = logging.getLogger(__name__)

KB = 1.3806488e-23  # J/K, value used by the reference (elastic/core.py:122)

# Voigt index -> cartesian pair, and the engineering-strain factors
CARTESIAN_TO_VOIGT = ((0, 0), (1, 1), (2, 2), (2, 1), (2, 0), (1, 0))
VOIGT_FACTORS = (1, 1, 1, 2, 2, 2)


def cummean(a, axis=0):
    """Cumulative mean along an axis."""
    a = np.asarray(a, dtype=np.float64)
    n = np.arange(1, a.shape[axis] + 1)
    shape = [1] * a.ndim
    shape[axis] = -1
    return np.cumsum(a, axis=axis) / n.reshape(shape)


class ElasticConstant:
    """Stiffness-matrix time series from a cell time series."""

    # reference exposes the running-mean helper as a static method
    # (amof/elastic/core.py:79-86)
    cummean = staticmethod(cummean)

    def __init__(self):
        self.temperature = None
        self.h = None
        self.step = None
        self.volume = None
        self.epsilons = None
        self.Cmat = labeled.DataArray(
            np.empty([0, 6, 6]),
            coords={
                "Step": np.empty([0], dtype=np.int64),
                "row": np.arange(1, 7),
                "col": np.arange(1, 7),
            },
            dims=("Step", "row", "col"),
            name="elastic",
        )

    @classmethod
    def from_cell(cls, h, temperature, final_value=False, step=None):
        """Args:
            h: sequence of cells in any form cell_from_any accepts.
            temperature: float, K.
            final_value: if True compute a single C from the full series.
            step: optional per-frame step labels.
        """
        new = cls()
        new.temperature = temperature
        new.set_h(h)
        new.set_step(step)
        new.set_volume()
        new.set_epsilons()
        if final_value:
            new.set_final_C()
        else:
            new.set_every_C()
        return new

    def set_h(self, h):
        self.h = np.array([cellmath.cell_from_any(c) for c in h])

    def set_step(self, step):
        self.step = None if step is None else np.array(step)

    def set_volume(self):
        self.volume = cummean(np.linalg.det(self.h))

    def set_epsilons(self):
        """Green-Lagrange strain of every frame w.r.t. frame 0."""
        inv_ref = np.linalg.inv(self.h[0])
        # g = h0^-T h^T h h0^-1 : g_ij = M_pi h_qp h_qr M_rj, M = h0^-1
        g = np.einsum("pi,tqp,tqr,rj->tij", inv_ref, self.h, self.h, inv_ref)
        self.epsilons = (g - np.eye(3)[None]) / 2.0

    def _voigt_strains(self):
        idx = np.array(CARTESIAN_TO_VOIGT)
        return self.epsilons[:, idx[:, 0], idx[:, 1]]  # [T, 6]

    def set_every_C(self):
        factor = (self.volume * 1.0e-30) / (KB * self.temperature)  # [T]
        eps = self._voigt_strains()  # [T, 6]
        fi = cummean(eps)  # [T, 6]
        fij = cummean(eps[:, :, None] * eps[:, None, :])  # [T, 6, 6]
        vf = np.array(VOIGT_FACTORS, dtype=np.float64)
        smat = (
            vf[None, :, None] * vf[None, None, :]
            * factor[:, None, None]
            * (fij - fi[:, :, None] * fi[:, None, :])
        )

        is_inversible = np.linalg.cond(smat) < 1 / sys.float_info.epsilon
        smat = smat[is_inversible]
        step = self.step
        if step is not None:
            step = step[is_inversible]
        cmat = np.linalg.inv(smat) / 1.0e9

        coords = {"row": np.arange(1, 7), "col": np.arange(1, 7)}
        if step is not None:
            coords["Step"] = step
        self.Cmat = labeled.DataArray(
            cmat, coords=coords, dims=("Step", "col", "row"), name="elastic"
        )

    def set_final_C(self):
        volume = self.volume[-1]
        factor = (volume * 1.0e-30) / (KB * self.temperature)
        eps = self._voigt_strains()
        fi = eps.mean(axis=0)
        fij = (eps[:, :, None] * eps[:, None, :]).mean(axis=0)
        vf = np.array(VOIGT_FACTORS, dtype=np.float64)
        smat = vf[:, None] * vf[None, :] * factor * (fij - np.outer(fi, fi))
        cmat = np.linalg.inv(smat) / 1.0e9
        self.Cmat = labeled.DataArray(
            cmat,
            coords={"row": np.arange(1, 7), "col": np.arange(1, 7)},
            dims=("col", "row"),
            name="elastic",
        )

    def write(self, filename):
        self.Cmat.to_netcdf(ampath.append_suffix(filename, "elastic"))

    # reference exposes both spellings across classes; keep write_to_file too
    write_to_file = write

    @classmethod
    def from_file(cls, filename):
        new = cls()
        new.read_elastic_file(filename)
        return new

    def read_elastic_file(self, filename):
        filename = ampath.append_suffix(filename, "elastic")
        self.Cmat = labeled.open_dataset(filename)["elastic"]


class MechanicalProperties:
    """Voigt/Reuss/Hill averaged moduli via the ELATE analysis
    (parity: amof/elastic/core.py:226-277)."""

    def __init__(self):
        self.data = pd.DataFrame()

    @classmethod
    def from_elastic(cls, C):
        """Args: C: 6x6 stiffness matrix (GPa), any form Elastic accepts."""
        new = cls()
        new.compute_averages(C)
        return new

    def compute_averages(self, C):
        if isinstance(C, labeled.DataArray):
            C = np.asarray(C.values)
        if isinstance(C, np.ndarray):
            C = C.tolist()
        el = elate.Elastic(C)
        prop = el.averages()
        df = pd.DataFrame(
            prop,
            index=["voigt", "reuss", "hill"],
            columns=["bulk_modulus", "youngs_modulus", "shear_modulus",
                     "poissons_ratio"],
        )
        df.index.name = "averaging_scheme"
        self.data = df

    @classmethod
    def from_file(cls, filename):
        new = cls()
        new.read_file(filename)
        return new

    def read_file(self, filename):
        filename = ampath.append_suffix(filename, "mech.csv")
        self.data = pd.read_csv(filename, index_col=0)

    def write(self, filename):
        filename = ampath.append_suffix(filename, "mech.csv")
        self.data.to_csv(filename)

    write_to_file = write


def print_Cmat(Cmat):
    """Pretty-print the upper triangle and eigenvalues of C (GPa)."""
    Cmat = np.asarray(Cmat)
    print("")
    print("Stiffness matrix C (GPa):")
    for i in range(6):
        print("    ", end=" ")
        for j in range(6):
            if j >= i:
                print(("% 8.2f" % Cmat[i, j]), end=" ")
            else:
                print("        ", end=" ")
        print("")
    print("")
    print("Stiffness matrix eigenvalues (GPa):")
    print((6 * "% 8.2f") % tuple(np.sort(np.linalg.eigvals(Cmat)).real))
