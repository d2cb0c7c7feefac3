"""Autocorrelation tempogram (batched, FFT-accelerated).

Mirror of reference ``features/period/tempogram_autocorr.rs:79-178``: for each
BPM hypothesis on the grid, the mean of ``novelty[i] * novelty[i + lag]`` with
``lag = floor(frame_rate / (bpm/60))``.

Batched reformulation: the reference's O(N * n_bpm) scalar loop is exactly
the linear autocorrelation sampled at the (static) lag set, so we compute one
zero-padded rFFT autocorrelation per track — ``ACF = irfft(|rfft(x)|^2)`` —
and gather the lags. Identical values (to float rounding), O(N log N).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .tempogram_fft import next_pow2


@functools.lru_cache(maxsize=64)
def bpm_grid(min_bpm: float, max_bpm: float, resolution: float) -> np.ndarray:
    """The reference's f32-accumulated BPM grid (``bpm += resolution`` while
    ``bpm <= max_bpm``, tempogram_autocorr.rs:128-162) reproduced with f32
    accumulation so grid values match bit-for-bit."""
    grid = []
    bpm = np.float32(min_bpm)
    mx = np.float32(max_bpm)
    res = np.float32(resolution)
    while bpm <= mx:
        grid.append(float(bpm))
        bpm = np.float32(bpm + res)
    return np.asarray(grid, dtype=np.float32)


@functools.lru_cache(maxsize=64)
def bpm_lags(min_bpm: float, max_bpm: float, resolution: float, frame_rate: float) -> np.ndarray:
    """Static per-hypothesis lags: floor(frame_rate / (bpm/60))
    (tempogram_autocorr.rs:133-140)."""
    grid = bpm_grid(min_bpm, max_bpm, resolution)
    fr = np.float32(frame_rate)
    lags = np.floor(fr / (grid / np.float32(60.0))).astype(np.int64)
    return lags


def linear_autocorrelation(x: jax.Array, max_lag: int) -> jax.Array:
    """ACF[l] = sum_i x[i]*x[i+l] for l in [0, max_lag] via rFFT."""
    n = x.shape[-1]
    nfft = next_pow2(n + max_lag + 1)
    spec = jnp.fft.rfft(x, n=nfft, axis=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    acf = jnp.fft.irfft(power, n=nfft, axis=-1)[..., : max_lag + 1]
    return jnp.maximum(acf.astype(jnp.float32), 0.0)


def autocorr_tempogram(
    novelty: jax.Array,
    nov_mask: jax.Array,
    n_valid: jax.Array,
    frame_rate: float,
    min_bpm: float,
    max_bpm: float,
    resolution: float,
):
    """Autocorrelation strengths over the BPM grid.

    Returns (strength [B, n_bpm], grid np[n_bpm]). strength = ACF[lag]/count
    with count = max(n_valid - lag, 0), 0 when count == 0
    (tempogram_autocorr.rs:141-158).
    """
    grid = bpm_grid(min_bpm, max_bpm, resolution)
    lags = bpm_lags(min_bpm, max_bpm, resolution, frame_rate)
    max_lag = int(lags.max()) if len(lags) else 0

    x = jnp.where(nov_mask, novelty, 0.0)
    acf = linear_autocorrelation(x, max_lag)  # [B, max_lag+1]
    lag_arr = jnp.asarray(lags)
    vals = acf[:, lag_arr]  # [B, n_bpm]
    count = jnp.maximum(n_valid[:, None] - lag_arr[None, :], 0)
    strength = jnp.where(count > 0, vals / jnp.maximum(count, 1), 0.0)
    return strength.astype(jnp.float32), grid


def ac_lookup_nearest(
    strength: jax.Array, grid: np.ndarray, query: jax.Array, tol: float
) -> jax.Array:
    """Nearest-grid-point lookup within ``tol`` BPM (tempogram.rs:518-529).

    The grid is uniform (up to f32 accumulation drift), so nearest =
    round((q - grid[0]) / resolution) clamped; validity re-checked against the
    true grid values.
    """
    g0 = float(grid[0])
    res = float(grid[1] - grid[0]) if len(grid) > 1 else 1.0
    # exact half-grid queries (every x.5 candidate from a 0.5x fold of an
    # odd seed against the default 1-BPM grid) must resolve to the LOWER
    # grid point: the reference's lookup keeps the FIRST nearest in
    # ascending iteration (tempogram.rs:518-529, `d < best_d`), and
    # jnp.round's half-to-even would pick the upper neighbor half the time
    idx = jnp.clip(
        jnp.ceil((query - g0) / res - 0.5).astype(jnp.int32), 0, len(grid) - 1
    )
    grid_arr = jnp.asarray(grid)
    ok = jnp.abs(grid_arr[idx] - query) <= tol
    vals = jnp.take_along_axis(
        strength, idx.reshape(strength.shape[0], -1), axis=-1
    ).reshape(query.shape)
    return jnp.where(ok, vals, 0.0)
