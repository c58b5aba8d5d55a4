"""
In-process Zeo++-equivalent pore analysis.

First-class replacement for the ``network`` binary subprocess the
reference shells out to (amof/pore/pysimmzeopp.py:52-158): same options
(ha/res/chan/sa/vol/psd/volpo), same defaults (probe_radius 1.2,
chan_radius 1.2, num_samples 50000 — :93-95), same output fields as the
.sa/.vol/.res files the reference parses (amof/pore/core.py:70-82),
but computed on device from a distance grid + periodic flood fill
instead of a Voronoi network (see grid_kernel docstring):

  -sa  -> ASA_A^2, ASA_m^2/cm^3, ASA_m^2/g, NASA_* (per-atom sphere
          sampling classified by void accessibility)
  -vol -> AV_A^3, AV_Volume_fraction, AV_cm^3/g, NAV_* (voxel
          integration of the probe-fit region; deterministic grid
          integration converges to the Zeo++ MC values — the contract
          is converged-value agreement, SURVEY.md §7 hard parts)
  -res -> Included_diameter, Free_diameter, Included_along_free
          (2*max d; percolation-threshold bisection; max d over the
          percolating region at threshold)
  -psd -> pore-size histogram = -dAV/dr over probe radius, 1000 bins of
          0.1 Å (the semantics documented at pysimmzeopp.py:76), PLUS
          the Gelb–Gubbins covering-sphere PSD (PSD_GG_*) computed by
          FFT spherical dilation of the distance field
  -ray_atom -> stochastic ray tracing: chord-length histogram of random
          rays through the accessible void (RayAtom_*), sphere-marched
          on the distance field
  -mass -> per-element mass overrides as a {symbol: amu} dict (affects
          Density and every *_cm^3/g, *_m^2/g field)
  extra -> in-process subset: -gridG/-gridBOV (distance grid array),
          -strinfo (structure summary), -oms (open metal sites),
          -axs (per-atom accessibility); other flags raise
  -volpo -> POAV_*: probe-occupiable volume = {d >= 0} voxels within
          r_probe of a probe-center voxel, split by accessibility
  -chan -> number of channels (distinct percolating components) and
          their dimensionality.

Radii default to the Zeo++ CSD table (amof_tpu/data/elements.py),
overridable per element (the ``-r`` radii-file option).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from amof_tpu.core import cellmath
from amof_tpu.data import elements
from amof_tpu.pore import grid_kernel

DEFAULT_PROBE_RADIUS = 1.2
DEFAULT_CHAN_RADIUS = 1.2
DEFAULT_NUM_SAMPLES = 50000

# unit conversions
A2_PER_A3_TO_M2_PER_CM3 = 1.0e4
AMU_TO_G = 1.66053906660e-24
A2_TO_M2 = 1.0e-20
A3_TO_CM3 = 1.0e-24


def _grid_dims(cell, resolution):
    # rounded up to multiples of 4 (slightly finer than requested), so
    # the grid splits evenly into slabs
    lengths = np.linalg.norm(np.asarray(cell, dtype=np.float64), axis=1)
    return tuple(
        int(-(-max(8, int(np.ceil(l / resolution))) // 4) * 4)
        for l in lengths
    )


def analyze_frame(
    frame,
    probe_radius: float = DEFAULT_PROBE_RADIUS,
    chan_radius: float = DEFAULT_CHAN_RADIUS,
    num_samples: int = DEFAULT_NUM_SAMPLES,
    sa: bool = False,
    vol: bool = False,
    res: bool = False,
    psd: bool = False,
    volpo: bool = False,
    chan: bool = False,
    block: bool = False,
    ray_atom: bool = False,
    radii: Optional[Dict[str, float]] = None,
    mass: Optional[Dict[str, float]] = None,
    resolution: float = 0.2,
    grid: Optional[tuple] = None,
    window="auto",
) -> Dict[str, float]:
    """Run the requested pore analyses on one frame; returns a flat dict
    keyed by the Zeo++ output-field names.

    ``window`` controls the sorted-window distance grid (see
    grid_kernel.distance_grid_windowed): "auto" sizes it from the
    density whenever only threshold consumers are requested (-res and
    -psd need the unclamped field), an int forces that width, None
    disables it. A window miss is detected exactly and falls back to
    the full O(V*N) grid."""
    cell = frame.get_cell().astype(np.float32)
    volume = cellmath.volume(cell)
    masses = frame.get_masses().astype(np.float64)
    if mass:  # per-element overrides (the Zeo++ -mass file option)
        symbols = np.array(frame.get_chemical_symbols())
        for sym, m in mass.items():
            masses[symbols == sym] = float(m)
    mass_amu = float(np.sum(masses))
    density_g_cm3 = mass_amu * AMU_TO_G / (volume * A3_TO_CM3)

    rad_table = elements.vdw_radius_array(overrides=radii)
    atom_radii = rad_table[frame.get_atomic_numbers()].astype(np.float32)
    frac = cellmath.cart_to_frac(frame.get_positions(), cell).astype(np.float32)
    frac = frac - np.floor(frac)

    if grid is None:
        grid = _grid_dims(cell, resolution)
    dist = None
    if window is not None and not res and not psd and not block and not ray_atom:
        # threshold-only consumers: the clamped sorted-window field is
        # exact below dmax and ~an order of magnitude cheaper
        dmax = float(max(probe_radius, chan_radius)) + 1e-3
        w0 = volume / float(np.linalg.norm(np.cross(cell[1], cell[2])))
        # coarse rounding keeps the static arg stable across NPT frames
        dxa = float(np.ceil((dmax + float(atom_radii.max())) / w0 / 5e-3)
                    * 5e-3)
        n_at = len(atom_radii)
        chunk = 2048  # pessimistic span for the adaptive chunk
        span = (chunk // (grid[1] * grid[2]) + 2) / grid[0]
        if window == "auto":
            w_est = 1.3 * n_at * (span + 2 * dxa) + 64
            window = int(-(-w_est // 128) * 128)
        if window < n_at:
            chunk = 2048 if int(window) <= 2048 else 1024
            d_w, missed = grid_kernel.distance_grid_windowed(
                frac, cell, atom_radii, grid, dmax=dmax, dxa=dxa,
                chunk=chunk, window=int(window),
            )
            if not bool(np.asarray(missed)):
                dist = d_w
    if dist is None:
        dist = grid_kernel.distance_grid(frac, cell, atom_radii, grid)
    voxel_volume = volume / (grid[0] * grid[1] * grid[2])

    # accessibility is defined by the channel probe (Zeo++ -sa/-vol pass
    # chan_radius first: pysimmzeopp.py:126-128). The per-frame path
    # uses the fully general displacement-vector winding test (exact
    # for multi-wrap composite channels, matching Zeo++'s criterion);
    # the batched path's device face test is exact for single-wrap.
    from amof_tpu.pore import winding

    mask, accessible, pocket = winding.void_classification_exact(
        np.asarray(dist) >= chan_radius
    )
    if probe_radius != chan_radius:
        fit = dist >= probe_radius
        acc_fit = fit & accessible
        poc_fit = fit & ~accessible
    else:
        fit, acc_fit, poc_fit = mask, accessible, pocket

    out: Dict[str, float] = {
        "Unitcell_volume": volume,
        "Density": density_g_cm3,
    }

    if sa:
        k = max(50, int(num_samples) // max(1, len(frame)))
        dirs = grid_kernel.fibonacci_sphere(k)
        acc_counts = None
        if window is not None:
            # blockers lie within R_i + R_j + 2*probe of a center: the
            # same sorted-window trick, miss-checked exactly
            w0 = volume / float(np.linalg.norm(np.cross(cell[1], cell[2])))
            reach = 2.0 * (float(atom_radii.max()) + float(probe_radius))
            w_est = 1.3 * len(atom_radii) * reach / w0 + 64  # reach already spans R_i+R_j+2p
            w_surf = int(-(-w_est // 128) * 128)
            if 32 + 2 * w_surf < len(atom_radii):
                a_s, n_s, gis, _, missed = (
                    grid_kernel.surface_point_classification_windowed(
                        frac, cell, atom_radii, float(probe_radius), dirs,
                        accessible, pocket, grid, window=w_surf,
                    )
                )
                if not bool(np.asarray(missed)):
                    gis = np.asarray(gis)
                    real = gis >= 0
                    acc_counts = np.zeros(len(atom_radii), np.int32)
                    nacc_counts = np.zeros(len(atom_radii), np.int32)
                    acc_counts[gis[real]] = np.asarray(a_s)[real]
                    nacc_counts[gis[real]] = np.asarray(n_s)[real]
        if acc_counts is None:
            acc_counts, nacc_counts = (
                grid_kernel.surface_point_classification(
                    frac, cell, atom_radii, float(probe_radius), dirs,
                    accessible, pocket, grid,
                )
            )
        sphere_areas = 4 * np.pi * (atom_radii + probe_radius) ** 2
        asa = float(np.sum(sphere_areas * np.asarray(acc_counts) / k))
        nasa = float(np.sum(sphere_areas * np.asarray(nacc_counts) / k))
        out["ASA_A^2"] = asa
        out["ASA_m^2/cm^3"] = asa / volume * A2_PER_A3_TO_M2_PER_CM3
        out["ASA_m^2/g"] = asa * A2_TO_M2 / (mass_amu * AMU_TO_G)
        out["NASA_A^2"] = nasa
        out["NASA_m^2/cm^3"] = nasa / volume * A2_PER_A3_TO_M2_PER_CM3
        out["NASA_m^2/g"] = nasa * A2_TO_M2 / (mass_amu * AMU_TO_G)

    if vol:
        av = float(jnp.sum(acc_fit)) * voxel_volume
        nav = float(jnp.sum(poc_fit)) * voxel_volume
        out["AV_A^3"] = av
        out["AV_Volume_fraction"] = av / volume
        out["AV_cm^3/g"] = av * A3_TO_CM3 / (mass_amu * AMU_TO_G)
        out["NAV_A^3"] = nav
        out["NAV_Volume_fraction"] = nav / volume
        out["NAV_cm^3/g"] = nav * A3_TO_CM3 / (mass_amu * AMU_TO_G)

    if res or chan:
        from amof_tpu.pore import winding

        d_np = np.asarray(dist)
        di = 2.0 * float(d_np.max())
        # largest free sphere: bisection on the percolation threshold
        # (general winding criterion, consistent with the -chan test)
        lo, hi = 0.0, float(d_np.max())
        for _ in range(20):
            mid = (lo + hi) / 2
            _, acc_mid, _ = winding.void_classification_exact(d_np >= mid)
            if acc_mid.any():
                lo = mid
            else:
                hi = mid
        df = 2.0 * lo
        _, acc_df, _ = winding.void_classification_exact(
            d_np >= max(lo - 1e-6, 0)
        )
        dif = 2.0 * float(d_np[acc_df].max()) if acc_df.any() else 0.0
        if res:
            out["Included_diameter"] = di
            out["Free_diameter"] = df
            out["Included_along_free"] = dif
        if chan:
            # channels = winding periodic components at chan_radius;
            # dimensionality = rank of each channel's winding lattice
            # (displacement vectors — Zeo++'s own identification,
            # exact for multi-wrap composite channels)
            open_labels = np.asarray(grid_kernel.label_components(
                np.asarray(mask), periodic=False
            ))
            chan_res = winding.channel_analysis(open_labels)
            out["Number_of_channels"] = float(chan_res["n_channels"])
            out["Channel_dimensionality"] = float(
                max(chan_res["dims"], default=0)
            )

    if psd:
        # -dAV/dr over probe radius: histogram of distance-field values on
        # the accessible void, 1000 bins of 0.1 Å (pysimmzeopp.py:76)
        d_acc = np.asarray(dist)[np.asarray(acc_fit)]
        hist, edges = np.histogram(
            2.0 * d_acc, bins=np.arange(0, 100.1, 0.1)
        )
        out["PSD_bin_A"] = edges[:-1]
        out["PSD_dAV_A^3"] = hist * voxel_volume
        # Gelb–Gubbins covering-sphere PSD — the pore-size definition
        # Zeo++'s -psd actually samples by MC (largest included sphere
        # covering each void point; Pinheiro et al. 2013): volume per
        # pore-DIAMETER bin of 0.1 Å, plus the cumulative curve.
        d_max = float(np.asarray(dist).max())
        # round the level count up to a multiple of 16 so NPT frames
        # with slightly different d_max share one compiled shape
        n_lev = min(-(-(int(np.ceil(d_max / 0.05)) + 1) // 16) * 16, 1001)
        levels = 0.05 * np.arange(n_lev)
        counts = np.asarray(grid_kernel.covering_volume_counts(
            dist, accessible, acc_fit, jnp.asarray(cell),
            levels.astype(np.float32), grid,
        ))
        vols = np.zeros(1001)
        vols[:n_lev] = counts * voxel_volume
        out["PSD_GG_bin_A"] = 0.1 * np.arange(1000)
        out["PSD_GG_dV_A^3"] = vols[:-1] - vols[1:]
        out["PSD_GG_cum_A^3"] = vols[:-1]

    if ray_atom:
        # -ray_atom stochastic ray tracing (pysimmzeopp.py:133-134):
        # chords of random rays through the accessible void, traced from
        # uniform points in the probe-accessible region to the atom
        # surfaces in both directions; histogrammed like -psd. Zeo++'s
        # MC is replaced by seeded sphere-marching on the distance
        # field (converged-value contract, SURVEY.md §7 hard parts).
        rng = np.random.default_rng(12345)
        acc_np = np.asarray(acc_fit)
        gvec = np.array(grid)
        n_rays = int(num_samples)
        pts = np.zeros((0, 3), np.float32)
        acc_frac = float(acc_np.mean())
        for _ in range(64 if acc_frac > 0 else 0):
            if len(pts) >= n_rays:
                break
            draw = min(int((n_rays - len(pts)) / acc_frac * 1.2) + 64,
                       4_000_000)
            cand = rng.random((draw, 3)).astype(np.float32)
            idx = np.minimum((cand * gvec).astype(int), gvec - 1)
            keep = acc_np[idx[:, 0], idx[:, 1], idx[:, 2]]
            pts = np.concatenate([pts, cand[keep]])
        pts = pts[:n_rays]
        if len(pts):
            dirs = rng.normal(size=(len(pts), 3)).astype(np.float32)
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            chords = np.asarray(grid_kernel.ray_chord_lengths(
                dist, jnp.asarray(pts), jnp.asarray(dirs),
                jnp.asarray(cell), 0.0, grid,
            ))
        else:
            chords = np.zeros(0, np.float32)
        hist_r, edges_r = np.histogram(chords, bins=np.arange(0, 100.1, 0.1))
        out["RayAtom_bin_A"] = edges_r[:-1]
        out["RayAtom_hist"] = hist_r.astype(np.float64)
        out["RayAtom_mean_A"] = float(chords.mean()) if len(chords) else 0.0
        out["RayAtom_samples"] = float(len(chords))

    if volpo:
        # probe-occupiable volume: every void voxel within probe_radius
        # of a probe-center voxel (dilation of the fit region by the
        # probe ball, approximated by 6-neighbor sweeps), split by
        # accessibility of the seeding centers
        steps = [
            int(np.ceil(probe_radius / (np.linalg.norm(cell[k]) / grid[k])))
            for k in range(3)
        ]
        n_sweeps = max(steps)
        occ = dist >= 0
        po_acc = grid_kernel.dilate(acc_fit, n_sweeps) & occ
        po_nacc = grid_kernel.dilate(poc_fit, n_sweeps) & occ & ~po_acc
        poav = float(jnp.sum(po_acc)) * voxel_volume
        ponav = float(jnp.sum(po_nacc)) * voxel_volume
        out["POAV_A^3"] = poav
        out["POAV_Volume_fraction"] = poav / volume
        out["POAV_cm^3/g"] = poav * A3_TO_CM3 / (mass_amu * AMU_TO_G)
        out["PONAV_A^3"] = ponav
        out["PONAV_Volume_fraction"] = ponav / volume
        out["PONAV_cm^3/g"] = ponav * A3_TO_CM3 / (mass_amu * AMU_TO_G)

    if block:
        # Blocking spheres (Zeo++ -block): cover every inaccessible
        # (pocket) probe-center voxel with spheres seeded greedily at
        # the pocket's distance-field maxima, so GCMC codes can exclude
        # probe insertions from isolated pockets. Spheres are
        # (fractional center, radius [A]); the union covers the pocket.
        labels = np.asarray(
            grid_kernel.label_components(jnp.asarray(poc_fit), True)
        )
        d_np = np.asarray(dist, dtype=np.float64)
        gxyz = np.array(grid, dtype=np.float64)
        cell64 = cell.astype(np.float64)
        voxel_diag = float(
            np.linalg.norm((1.0 / gxyz)[:, None] * cell64, axis=1).max()
        )
        spheres = []
        for lab in np.unique(labels[labels >= 0]):
            idx = np.argwhere(labels == lab)
            fracs = (idx + 0.5) / gxyz
            dvals = d_np[idx[:, 0], idx[:, 1], idx[:, 2]]
            covered = np.zeros(len(idx), bool)
            for _ in range(len(idx)):
                if covered.all():
                    break
                i = int(np.argmax(np.where(covered, -np.inf, dvals)))
                c = fracs[i]
                r = float(dvals[i])
                df = fracs - c
                df -= np.round(df)
                dcart = np.linalg.norm(df @ cell64, axis=1)
                covered |= dcart <= r + 0.5 * voxel_diag
                covered[i] = True  # guarantee progress
                spheres.append((c[0], c[1], c[2], r))
        out["Number_of_blocking_spheres"] = float(len(spheres))
        out["Blocking_spheres"] = np.array(
            spheres, dtype=np.float64
        ).reshape(-1, 4)

    return out


def network(frame_or_file, **kwargs) -> Dict[str, float]:
    """Drop-in functional replacement for pysimm-style
    ``network(input, sa=True, vol=True, ...)`` — but in-process: takes a
    Frame (or an xyz file path) and returns the result dict instead of
    writing .sa/.vol files (parity: amof/pore/pysimmzeopp.py:52-158)."""
    frame = frame_or_file
    if isinstance(frame_or_file, str):
        if str(frame_or_file).endswith(".cif"):
            from amof_tpu.io.cif import read_cif

            frame = read_cif(frame_or_file)
        else:
            from amof_tpu.io.xyz import read_xyz

            frame = read_xyz(frame_or_file, 0)
    # translate pysimm kwarg names
    kwargs.pop("ha", None)  # grid resolution already 'high accuracy'
    kwargs.pop("atype_name", None)
    extra = kwargs.pop("extra", None)
    for opt in ("radii", "mass"):
        if opt in kwargs and isinstance(kwargs[opt], str):
            raise ValueError(
                f"{opt} files are not supported; pass a "
                f"{{symbol: value}} dict"
            )
    result = analyze_frame(frame, **kwargs)
    if extra:
        result.update(_run_extra_options(frame, extra, kwargs))
    return result


def _run_extra_options(frame, extra: str, kwargs) -> Dict[str, float]:
    """Subset of the free-form ``extra`` CLI passthrough
    (amof/pore/pysimmzeopp.py:77,136-137). Supported: -gridG / -gridBOV
    (the distance grid the binary would write as a Gaussian-cube / BOV
    file — returned in-process as an array), -strinfo (structure
    summary), -oms (open-metal-site count), -axs (per-atom
    accessibility array). Anything else raises NotImplementedError
    naming the flag.
    """
    out: Dict[str, float] = {}
    tokens = extra.split()
    i = 0
    while i < len(tokens):
        flag = tokens[i]
        if flag in ("-gridG", "-gridBOV"):
            cell = frame.get_cell().astype(np.float32)
            grid = kwargs.get("grid") or _grid_dims(
                cell, kwargs.get("resolution", 0.2)
            )
            rad_table = elements.vdw_radius_array(
                overrides=kwargs.get("radii")
            )
            atom_radii = rad_table[frame.get_atomic_numbers()].astype(
                np.float32
            )
            frac = cellmath.cart_to_frac(
                frame.get_positions(), cell
            ).astype(np.float32)
            frac = frac - np.floor(frac)
            out["Distance_grid"] = np.asarray(
                grid_kernel.distance_grid(frac, cell, atom_radii, grid)
            )
            out["Distance_grid_shape"] = np.array(grid, dtype=np.float64)
            i += 1
        elif flag == "-oms":
            # open-metal-site detection (Zeo++ -oms): a metal site is
            # "open" when the probe can reach its coordination sphere —
            # detected here as the metal atom having at least one
            # ACCESSIBLE surface sample point at the analysis probe
            # radius (converged-value contract, SURVEY.md §7 hard
            # parts: Zeo++ inspects the coordination polyhedron; an
            # exposed metal has accessible surface iff the polyhedron
            # leaves a probe-sized opening).
            out.update(_count_open_metal_sites(frame, kwargs))
            i += 1
        elif flag == "-axs":
            # per-atom accessibility (Zeo++ -axs <probe> <file>: one
            # true/false line per atom). In-process contract: returned
            # as a bool array instead of a file; an optional numeric
            # token overrides the probe radius, a filename token is
            # accepted and ignored.
            i += 1
            axs_kwargs = dict(kwargs)
            while i < len(tokens) and not tokens[i].startswith("-"):
                try:
                    axs_kwargs["probe_radius"] = float(tokens[i])
                except ValueError:
                    pass  # output filename — in-process, ignored
                i += 1
            out["Atom_accessibility"] = _atom_accessibility(
                frame, axs_kwargs
            )
        elif flag == "-strinfo":
            syms, counts = np.unique(
                frame.get_chemical_symbols(), return_counts=True
            )
            out["Formula"] = "".join(
                f"{s}{c}" for s, c in zip(syms, counts)
            )
            out["Number_of_atoms"] = float(len(frame))
            out["Unitcell_volume"] = cellmath.volume(frame.get_cell())
            i += 1
        else:
            raise NotImplementedError(
                f"extra Zeo++ option {flag!r} is not supported "
                f"(supported: -gridG, -gridBOV, -strinfo, -oms, -axs)"
            )
    return out


# non-metals excluded from -oms (everything else counts as metal, the
# same breadth as Zeo++'s metal table)
_NON_METALS = frozenset(
    [1, 2, 5, 6, 7, 8, 9, 10, 14, 15, 16, 17, 18, 33, 34, 35, 36,
     52, 53, 54, 85, 86]
)


def _atom_accessibility(frame, kwargs) -> np.ndarray:
    """bool[N]: does the probe reach each atom's surface? (Zeo++ -axs
    per-atom accessibility; also the -oms exposure test.)"""
    from amof_tpu.pore import winding

    probe = float(kwargs.get("probe_radius", DEFAULT_PROBE_RADIUS))
    chan = float(kwargs.get("chan_radius", DEFAULT_CHAN_RADIUS))
    num_samples = int(kwargs.get("num_samples", DEFAULT_NUM_SAMPLES))
    cell = frame.get_cell().astype(np.float32)
    grid = kwargs.get("grid") or _grid_dims(
        cell, kwargs.get("resolution", 0.2)
    )
    rad_table = elements.vdw_radius_array(overrides=kwargs.get("radii"))
    numbers = frame.get_atomic_numbers()
    atom_radii = rad_table[numbers].astype(np.float32)
    frac = cellmath.cart_to_frac(frame.get_positions(), cell).astype(
        np.float32
    )
    frac = frac - np.floor(frac)
    dist = grid_kernel.distance_grid(frac, cell, atom_radii, grid)
    _, accessible, pocket = winding.void_classification_exact(
        np.asarray(dist) >= chan
    )
    k = max(50, num_samples // max(1, len(numbers)))
    dirs = grid_kernel.fibonacci_sphere(k)
    acc_counts, _ = grid_kernel.surface_point_classification(
        frac, cell, atom_radii, probe, dirs,
        np.asarray(accessible), np.asarray(pocket), grid,
    )
    return np.asarray(acc_counts) > 0


def _count_open_metal_sites(frame, kwargs) -> Dict[str, float]:
    """Count metal atoms with probe-accessible surface (-oms)."""
    numbers = frame.get_atomic_numbers()
    is_metal = ~np.isin(numbers, list(_NON_METALS))
    open_sites = is_metal & _atom_accessibility(frame, kwargs)
    return {
        "Number_of_open_metal_sites": float(open_sites.sum()),
        "Number_of_metal_sites": float(is_metal.sum()),
    }
