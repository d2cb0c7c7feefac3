"""Energy-flux onset detection (batched).

Mirror of reference ``onset/energy_flux.rs:67-243``: frame RMS -> half-wave
rectified derivative -> dB threshold relative to max -> local-max peak pick ->
min-distance dedup at hop/2. Frame RMS is computed with prefix sums (no frame
materialization); everything else is mask algebra over ``[B, NF]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...ops import masked
from .peaks import dedup_min_distance, peak_mask_1d, peaks_to_positions

EPSILON = 1e-10


def frame_rms_energies(samples: jax.Array, lengths: jax.Array, frame_size: int, hop: int):
    """Per-frame RMS over the reference's frame grid
    (energy_flux.rs:105-131): frames at ``i*hop``, clamped to the signal end.

    Returns (rms [B, NF], n_frames [B]) on the padded grid.
    """
    b, t = samples.shape
    nf = max((t - frame_size) // hop + 1, 1)
    # Blocked frame sums (ops/framesum.py): exact given zero padding beyond
    # lengths; a per-sample cumsum costs O(log T) passes over the samples.
    from ...ops.framesum import frame_sumsq

    sums = frame_sumsq(samples, frame_size, hop, nf)
    starts = jnp.arange(nf) * hop
    ends = jnp.minimum(starts[None, :] + frame_size, jnp.maximum(lengths, 1)[:, None])
    ends = jnp.maximum(ends, starts[None, :] + 1)
    cnt = (ends - starts[None, :]).astype(sums.dtype)
    rms = jnp.sqrt(jnp.maximum(sums, 0.0) / cnt)
    n_frames = jnp.where(lengths >= frame_size, (lengths - frame_size) // hop + 1, 0)
    return rms, n_frames.astype(jnp.int32)


def detect_energy_flux_onsets(
    samples: jax.Array,
    lengths: jax.Array,
    frame_size: int,
    hop: int,
    threshold_db: float,
    max_onsets: int,
    mesh=None,
):
    """Detect onsets; returns (positions [B, K] int32 samples, valid [B, K]).

    Onset position convention matches the reference: flux index i (transition
    frame i -> i+1) maps to sample ``(i+1)*hop``, kept only if inside the
    track (energy_flux.rs:183-191).

    With a ``(tracks, time)`` ``mesh``, the frame-RMS pass runs time-sharded
    (parallel.timeblocks); the flux/peak logic below operates on the tiny
    gathered [B, NF] curve.
    """
    b, t = samples.shape
    if mesh is not None and "time" in mesh.shape:
        from ...parallel.timeblocks import frame_rms_sharded

        rms, n_frames = frame_rms_sharded(samples, lengths, frame_size, hop, mesh)
    else:
        rms, n_frames = frame_rms_energies(samples, lengths, frame_size, hop)
    nf = rms.shape[1]

    flux = jnp.maximum(rms[:, 1:] - rms[:, :-1], 0.0)  # [B, NF-1]
    n_flux = jnp.maximum(n_frames - 1, 0)
    fvalid = masked.length_mask(n_flux, nf - 1)
    flux = jnp.where(fvalid, flux, 0.0)

    max_flux = masked.masked_max(flux, fvalid)
    threshold = max_flux * (10.0 ** (threshold_db / 20.0))
    # no onsets when all flux ~ 0 (energy_flux.rs:151-155)
    threshold = jnp.where(max_flux > EPSILON, threshold, jnp.inf)

    peaks = peak_mask_1d(flux, fvalid, threshold)
    onset_samples = (jnp.arange(nf - 1, dtype=jnp.int32) + 1) * hop
    peaks = peaks & (onset_samples[None, :] < lengths[:, None])

    pos, valid = peaks_to_positions(peaks, onset_samples, max_onsets)
    valid = valid & dedup_min_distance(pos, valid, hop // 2)
    return jnp.where(valid, pos, 0), valid
