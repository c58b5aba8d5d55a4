"""
Windowed MSD via FFT autocorrelation (Wiener-Khinchin).

Replaces the reference's O(N_frames x N_windows) rolling-sum loop
(amof/msd.py:186-205) with an O(N log N) on-device computation:

    S(m) = sum_{k=0}^{T-m-1} |r_{k+m} - r_k|^2
         = S1(m) - 2 * AC(m),
    S1(m) = 2*Q - sum_{k<m} D_k - sum_{k>=T-m} D_k,   D_k = |r_k|^2,
    AC(m) = sum_k r_k . r_{k+m}   (via zero-padded rFFT)

The reference's estimator skips the k=0 origin for every window m>0 while
still dividing by (T-m) — its MSD_partial[0] is allocated but never
written (amof/msd.py:195-204). ``origin_policy='amof'`` reproduces that
exactly (subtract the |r_m - r_0|^2 term); ``'standard'`` keeps all
origins.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from amof_tpu.ops.pair_engine import min_image_delta


@functools.partial(jax.jit, static_argnames=("origin_policy",))
def windowed_msd_atom_series(x, origin_policy: str = "amof"):
    """Per-atom sum over origins of |r_{k+m} - r_k|^2 for every m.

    Returns: f32[T, A] (sum over atoms of interest and divide by
    N * (T - m) for the MSD). Building block for per-species splits and
    the atom-sharded multichip path (partial atom sums psum cleanly).
    """
    T, A, _ = x.shape
    n_fft = 2 * T  # zero-pad for linear (non-circular) autocorrelation
    # every term is translation-invariant per atom: centring each atom's
    # path on its time mean shrinks |r|^2 from the box scale to the
    # displacement scale, and with it the f32 cancellation in S1 - 2 AC
    x = x - jnp.mean(x, axis=0, keepdims=True)

    D = jnp.sum(x * x, axis=-1)  # [T, A]
    X = jnp.fft.rfft(x, n=n_fft, axis=0)
    ac = jnp.fft.irfft(X * jnp.conj(X), n=n_fft, axis=0)[:T]  # [T, A, 3]
    ac = jnp.sum(ac, axis=-1)  # [T, A] : AC(m) per atom

    q_tot = jnp.sum(D, axis=0)  # [A]
    csum = jnp.cumsum(D, axis=0)  # [T, A]
    m = jnp.arange(T)
    # head(m) = sum_{k=0}^{m-1} D_k ; tail(m) = q - sum_{k=0}^{T-m-1} D_k
    head = jnp.concatenate([jnp.zeros((1, A), D.dtype), csum[:-1]], axis=0)
    tail = q_tot[None, :] - csum[T - 1 - m]
    s = (2 * q_tot[None, :] - head - tail) - 2 * ac  # [T, A]

    if origin_policy == "amof":
        # remove the k=0 origin pair (r_m vs r_0) the reference skips
        s = s - jnp.sum((x - x[0][None]) ** 2, axis=-1)
    return s


@functools.partial(jax.jit, static_argnames=("origin_policy",))
def windowed_msd_atom_sums(x, origin_policy: str = "amof"):
    """Sum over atoms and origins of |r_{k+m} - r_k|^2 for every m.
    Returns f32[T]."""
    return jnp.sum(windowed_msd_atom_series(x, origin_policy), axis=1)


@functools.partial(jax.jit, static_argnames=("origin_policy",))
def windowed_msd_all_m(x, origin_policy: str = "amof"):
    """MSD(m) for every window m in [0, T).

    Args:
        x: f32[T, A, 3] unwrapped (and COM-corrected) positions.
        origin_policy: 'amof' (reference estimator) or 'standard'.

    Returns:
        f32[T]: MSD(m) averaged over origins and atoms.
    """
    T, A, _ = x.shape
    m = jnp.arange(T)
    s = windowed_msd_atom_sums(x, origin_policy)
    msd = s / (A * (T - m))
    return msd.at[0].set(0.0)  # MSD(0) is exactly 0; kill FFT roundoff


@jax.jit
def unwrap_positions(positions, cells):
    """Reconstruct unwrapped positions from minimum-image consecutive
    displacements — the functional equivalent of ``get_delta_pos`` +
    cumulative resummation (amof/trajectory.py:285-303,
    amof/msd.py:222-230).

    Args:
        positions: f32[T, A, 3]; cells: f32[T, 3, 3].
    """
    inv_cells = jnp.linalg.inv(cells)
    delta = positions[1:] - positions[:-1]  # [T-1, A, 3]

    def wrap_one(args):
        d, cell, inv = args
        return min_image_delta(d, cell, inv)

    wrapped = jax.lax.map(wrap_one, (delta, cells[:-1], inv_cells[:-1]))
    return jnp.concatenate(
        [positions[0][None], positions[0][None] + jnp.cumsum(wrapped, axis=0)],
        axis=0,
    )


@jax.jit
def remove_com_drift(positions, masses):
    """Subtract the mass-weighted center of mass of every frame
    (amof/msd.py:235-237)."""
    w = (masses / jnp.sum(masses))[None, :, None]
    com = jnp.sum(positions * w, axis=1, keepdims=True)
    return positions - com
