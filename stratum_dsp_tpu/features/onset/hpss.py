"""Harmonic/percussive source separation (median-filter HPSS, batched).

Mirror of reference ``onset/hpss.rs:71-243``: iterative refinement where the
harmonic estimate is median-filtered across time, the percussive estimate
across frequency, then both are soft-masked so H + P == |X|. The reference
runs up to 10 iterations with an early-exit when max change < 1e-6
(hpss.rs:158-170); here we run the fixed iteration count — the early exit
only skips iterations whose updates are below 1e-6 anyway, and fixed trip
counts keep the program static.

Cost note: each iteration sorts a (2*margin+1)-wide window per spectrogram
cell. Callers should feed band-limited / downsampled spectrograms (as the
reference's key path does, extractor.rs:1369-1501); HPSS onsets are off by
default (config.rs:619-621).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...ops import masked

DEFAULT_ITERATIONS = 10
EPSILON = 1e-10


def hpss_decompose(
    spec: jax.Array,
    frame_counts: jax.Array,
    margin: int,
    iterations: int = DEFAULT_ITERATIONS,
):
    """Decompose ``spec [B, F, K]`` into (harmonic, percussive), same shapes.

    ``frame_counts [B]`` bounds the time-axis median window per track.
    """
    b, f, k = spec.shape
    harmonic = spec
    percussive = spec

    for _ in range(iterations):
        # horizontal (time) median for harmonic: time on the last axis
        h_t = jnp.swapaxes(harmonic, 1, 2)  # [B, K, F]
        h_t = masked.masked_median_filter_1d(h_t, frame_counts[:, None], margin)
        h = jnp.swapaxes(h_t, 1, 2)
        # vertical (frequency) median for percussive
        p = masked.masked_median_filter_1d(percussive, jnp.full((b, 1), k), margin)
        # soft-mask reconstruction (hpss.rs:131-151)
        total = h + p
        ratio_h = jnp.where(total > EPSILON, h / jnp.maximum(total, EPSILON), 0.5)
        harmonic = spec * ratio_h
        percussive = spec * (1.0 - ratio_h)

    return harmonic, percussive


def percussive_energy_flux(percussive: jax.Array, frame_counts: jax.Array):
    """Per-frame percussive energy (sum |P|^2) and its HWR flux
    (hpss.rs:300-320). Returns (flux [B, F-1], n_valid [B])."""
    # Upcast before accumulating: if a caller ever hands in a reduced-
    # precision spectrogram, summing ~1025 bins in bf16 loses the HWR first
    # difference of near-equal frame energies (matches the upcasts in
    # novelty.py / key/pipeline.py).
    percussive = percussive.astype(jnp.float32)
    energy = jnp.sum(percussive * percussive, axis=-1)  # [B, F]
    f = energy.shape[-1]
    fmask = masked.length_mask(frame_counts, f)
    energy = jnp.where(fmask, energy, 0.0)
    flux = jnp.maximum(energy[:, 1:] - energy[:, :-1], 0.0)
    return flux, jnp.maximum(frame_counts - 1, 0)
