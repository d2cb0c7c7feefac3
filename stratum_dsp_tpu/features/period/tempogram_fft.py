"""FFT tempogram (batched).

Mirror of reference ``features/period/tempogram_fft.rs:78-236``: DC removal,
Hann window over the novelty curve, zero-padded power spectrum, frequency
bins -> BPM (Hz * 60) restricted to the BPM range.

Batching notes: the FFT size is the static next power of two of the *padded*
novelty length (the reference uses the per-track next power of two; a larger
size only refines the BPM grid). The Hann window denominator uses the traced
per-track valid length, matching the reference's per-track window exactly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

EPSILON = 1e-10


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# Minimum BPM granularity of the FFT-tempogram grid. The reference pads only
# to next_pow2(len(novelty)) (tempogram_fft.rs:119-125), which at short track
# lengths coarsens the grid to ~5 BPM — candidates snap to off-tempo bins
# (e.g. 121.12 for a true 120) and the beat grid drifts. Zero-padding is pure
# spectral interpolation (same continuous spectrum, finer sampling), so
# enforcing a resolution finer than the 0.75-BPM dedup tolerance fixes the
# short-track snap without touching any scoring threshold.
MIN_RESOLUTION_BPM = 0.7


def padded_fft_size(n: int, frame_rate: float) -> int:
    """FFT size: next pow2 of the novelty length, zero-padded so the BPM grid
    spacing frame_rate*60/fft_size is at most MIN_RESOLUTION_BPM."""
    need = int(np.ceil(frame_rate * 60.0 / MIN_RESOLUTION_BPM))
    return next_pow2(max(n, need))


@functools.lru_cache(maxsize=64)
def fft_bpm_bins(
    fft_size: int, frame_rate: float, min_bpm: float, max_bpm: float
) -> Tuple[int, int, np.ndarray]:
    """Static in-range rFFT bin span: (bin_lo, bin_hi_inclusive, bpm_values).

    bin -> BPM = bin * (frame_rate / fft_size) * 60 (tempogram_fft.rs:159-179);
    only bins with BPM in [min_bpm, max_bpm] are kept, up to Nyquist.
    """
    freq_res = frame_rate / fft_size
    n_bins = fft_size // 2 + 1
    bpms = np.arange(n_bins) * freq_res * 60.0
    inside = np.nonzero((bpms >= min_bpm) & (bpms <= max_bpm))[0]
    if len(inside) == 0:
        return 0, 0, np.zeros(1, np.float32)
    lo, hi = int(inside[0]), int(inside[-1])
    return lo, hi, bpms[lo : hi + 1].astype(np.float32)


def fft_tempogram_power(
    novelty: jax.Array,
    nov_mask: jax.Array,
    n_valid: jax.Array,
    frame_rate: float,
    min_bpm: float,
    max_bpm: float,
    fft_size: int,
):
    """Power spectrum of the conditioned novelty over the in-range BPM bins.

    Returns (power [B, n_range_bins], bpm_values [n_range_bins] np array).
    """
    b, n = novelty.shape
    assert fft_size >= n
    mean = jnp.sum(jnp.where(nov_mask, novelty, 0.0), axis=-1, keepdims=True) / jnp.maximum(
        n_valid, 1
    )[:, None]
    i = jnp.arange(n, dtype=jnp.float32)
    denom = jnp.maximum(n_valid.astype(jnp.float32) - 1.0, 1.0)[:, None]
    w = 0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * i[None, :] / denom))
    w = jnp.where(n_valid[:, None] > 1, w, 1.0)
    x = jnp.where(nov_mask, (novelty - mean) * w, 0.0)
    spec = jnp.fft.rfft(x, n=fft_size, axis=-1)
    power = (spec.real * spec.real + spec.imag * spec.imag).astype(jnp.float32)
    lo, hi, bpms = fft_bpm_bins(fft_size, frame_rate, min_bpm, max_bpm)
    return power[:, lo : hi + 1], bpms


def fft_lookup_nearest(
    power: jax.Array, bpms: np.ndarray, query: jax.Array, tol: float, frame_rate: float, fft_size: int
) -> jax.Array:
    """Nearest-bin lookup within ``tol`` BPM over the in-range power bins
    (tempogram.rs:518-529 ``lookup_nearest``). ``query`` broadcasts over any
    shape; returns 0 where no bin is within tol."""
    freq_res = frame_rate / fft_size
    lo_bpm = float(bpms[0]) if len(bpms) else 0.0
    # half-grid ties resolve LOW (first-nearest in ascending iteration,
    # tempogram.rs:518-529); see ac_lookup_nearest
    idx = jnp.ceil(query / (freq_res * 60.0) - 0.5).astype(jnp.int32)
    lo_bin = int(round(lo_bpm / (freq_res * 60.0)))
    idx = jnp.clip(idx - lo_bin, 0, power.shape[-1] - 1)
    bin_bpm = (idx + lo_bin).astype(jnp.float32) * (freq_res * 60.0)
    ok = jnp.abs(bin_bpm - query) <= tol
    vals = jnp.take_along_axis(
        power, idx.reshape(power.shape[0], -1), axis=-1
    ).reshape(query.shape)
    return jnp.where(ok, vals, 0.0)


def prominence_confidence(top1: jax.Array, top2: jax.Array) -> jax.Array:
    """(best - second)/best prominence (tempogram_fft.rs:215-229)."""
    return jnp.where(
        top1 > EPSILON, jnp.clip((top1 - top2) / jnp.maximum(top1, EPSILON), 0.0, 1.0), 0.0
    )
