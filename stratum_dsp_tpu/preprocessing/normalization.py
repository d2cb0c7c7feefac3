"""Batched audio normalization: Peak / RMS / LUFS (ITU-R BS.1770-4).

Mirror of the reference ``preprocessing/normalization.rs``. The one truly
sequential piece — the K-weighting biquad applied per sample
(``normalization.rs:112-175``) — is re-expressed for batched hardware: a constant-
coefficient order-2 IIR has an exponentially decaying impulse response (pole
radius ~0.867 for the K-weighting high-pass at 44.1 kHz), so a truncated-FIR
convolution of a few hundred taps reproduces it to ~1e-8 relative error. That
turns an 8M-step scan into one batched convolution that XLA runs as matmuls.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import NormalizationMethod
from ..ops import masked

EPSILON = 1e-10
LUFS_GATE_THRESHOLD = -70.0
LUFS_BLOCK_DURATION_MS = 400.0

# Impulse-response truncation: measured tail max 3.6e-17 of peak at 256 taps
# for 44.1 kHz (decay scales ~1/sr: still <=1e-7 at 96 kHz) — far inside the
# 1e-4 FIR-vs-IIR contract. 256 also tiles cleanly ([512]-contraction split
# into two [256, 256] matmuls); 512 taps double the cost for no accuracy
# benefit.
KWEIGHT_FIR_TAPS = 256


@functools.lru_cache(maxsize=8)
def k_weighting_coeffs(sample_rate: float) -> Tuple[float, float, float, float, float]:
    """Normalized biquad coefficients (b0,b1,b2,a1,a2) of the K-weighting
    high-pass shelving stage (normalization.rs:131-158)."""
    w0 = 2.0 * math.pi * 1_681.974_5 / sample_rate
    cos_w0 = math.cos(w0)
    sin_w0 = math.sin(w0)
    alpha = sin_w0 / 2.0 * math.sqrt(1.0 / 0.707)
    b0 = (1.0 + cos_w0) / 2.0
    b1 = -(1.0 + cos_w0)
    b2 = (1.0 + cos_w0) / 2.0
    a0 = 1.0 + alpha
    a1 = -2.0 * cos_w0
    a2 = 1.0 - alpha
    return (b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


@functools.lru_cache(maxsize=8)
def k_weighting_fir(sample_rate: float, n_taps: int = KWEIGHT_FIR_TAPS) -> np.ndarray:
    """Truncated impulse response of the K-weighting biquad (float64 host
    computation; decays below 1e-12 well inside n_taps)."""
    b0, b1, b2, a1, a2 = k_weighting_coeffs(sample_rate)
    h = np.zeros(n_taps, dtype=np.float64)
    x1 = x2 = 0.0
    x = 1.0
    for i in range(n_taps):
        y = b0 * x + x1
        x1 = b1 * x + x2 - a1 * y
        x2 = b2 * x - a2 * y
        h[i] = y
        x = 0.0
    return h.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _k_weighting_toeplitz(sample_rate: float, blk: int = KWEIGHT_FIR_TAPS) -> np.ndarray:
    """Banded-Toeplitz FIR matrix ``H [2*blk, blk]``: with the signal split
    into ``blk``-sample blocks, ``y_block[i] = [x_block[i-1] | x_block[i]] @ H``.
    ``H[p, j] = h[blk + j - p]`` where in-range — this routes the 512-tap FIR
    through a matmul instead of a single-channel conv."""
    h = k_weighting_fir(sample_rate, blk)
    H = np.zeros((2 * blk, blk), dtype=np.float32)
    p = np.arange(2 * blk)[:, None]
    j = np.arange(blk)[None, :]
    k = blk + j - p
    ok = (k >= 0) & (k < blk)
    H[ok] = h[k[ok]]
    return H


def k_weighting_filter(
    samples: jax.Array, sample_rate: float, bf16: bool = False
) -> jax.Array:
    """Apply the K-weighting filter to ``[B, T]`` samples as a blocked
    Toeplitz matmul (exact truncated-FIR; zero initial state).

    The filter output feeds ONLY the LUFS energy measurement (the gain is
    applied to the raw samples), so with ``bf16`` the matmul runs one bf16
    pass: ~0.4% worst-case energy error == ~0.02 dB LUFS, far inside the
    1 dB headroom logic. Off by default AND off in the production pipeline
    (pipeline.py passes bf16=False)."""
    b, t = samples.shape
    blk = KWEIGHT_FIR_TAPS
    nb = -(-t // blk)
    pad = nb * blk - t
    x = jnp.pad(samples, ((0, 0), (0, pad))) if pad else samples
    xb = x.reshape(b, nb, blk)
    H = jnp.asarray(_k_weighting_toeplitz(sample_rate, blk))
    # split the [prev | cur] window contraction into two [blk, blk] matmuls
    # so no concatenated 2x signal copy materializes in HBM
    Hp, Hc = H[:blk], H[blk:]
    prev = jnp.concatenate([jnp.zeros((b, 1, blk), x.dtype), xb[:, :-1]], axis=1)
    if bf16:
        xb16, prev16 = xb.astype(jnp.bfloat16), prev.astype(jnp.bfloat16)
        y = jnp.matmul(xb16, Hc.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        y = y + jnp.matmul(prev16, Hp.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    else:
        # HIGH is f32 on the CPU (inside the 1e-4 FIR-vs-IIR contract) and
        # TF32 on the GPU: ~1e-3 relative per output sample, which averages
        # out in the 400 ms LUFS block energies (GPU-vs-CPU decision parity:
        # chip_smoke.py phase d)
        y = jnp.matmul(xb, Hc, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGH)
        y = y + jnp.matmul(prev, Hp, preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGH)
    return y.reshape(b, nb * blk)[:, :t]


def calculate_lufs(
    samples: jax.Array, lengths: jax.Array, sample_rate: float,
    bf16: bool = False,
) -> jax.Array:
    """Integrated LUFS per track (normalization.rs:185-259).

    K-weighting -> 400ms block mean-squares -> -70 LUFS absolute gate ->
    mean of gated blocks -> -0.691 + 10*log10. Returns -inf where every block
    is below the gate.
    """
    b, t = samples.shape
    block = int(sample_rate * LUFS_BLOCK_DURATION_MS / 1000.0)
    filtered = k_weighting_filter(samples, sample_rate, bf16=bf16)
    # Zero out padding (FIR tail can leak past the valid region).
    valid = masked.length_mask(lengths, t)
    filtered = jnp.where(valid, filtered, 0.0)

    n_blocks = -(-t // block)
    pad = n_blocks * block - t
    f2 = jnp.pad(filtered * filtered, ((0, 0), (0, pad))).reshape(b, n_blocks, block)
    sums = jnp.sum(f2, axis=-1)
    # Block sample counts: full blocks except a possibly short final one
    # (div_ceil blocks over the *valid* length).
    starts = jnp.arange(n_blocks) * block
    counts = jnp.clip(lengths[:, None] - starts[None, :], 0, block)
    block_valid = counts > 0
    mean_sq = sums / jnp.maximum(counts, 1)

    gate_linear = 10.0 ** ((LUFS_GATE_THRESHOLD + 0.691) / 10.0)
    gated = block_valid & (mean_sq > gate_linear)
    n_gated = jnp.sum(gated, axis=-1)
    mean_gated = jnp.sum(jnp.where(gated, mean_sq, 0.0), axis=-1) / jnp.maximum(n_gated, 1)
    lufs = -0.691 + 10.0 * jnp.log10(jnp.maximum(mean_gated, EPSILON))
    return jnp.where(n_gated > 0, lufs, -jnp.inf)


def normalize(
    samples: jax.Array,
    lengths: jax.Array,
    method: NormalizationMethod,
    sample_rate: float,
    target_loudness_lufs: float = -14.0,
    max_headroom_db: float = 1.0,
    bf16: bool = False,
):
    """Normalize ``[B, T]`` tracks in a batch; returns (samples, metadata dict).

    Metadata: peak_db, rms_db, gain_db, measured_lufs ([B] arrays; -inf where
    undefined). Silent tracks get gain 1.0 (normalization.rs:275-283).
    """
    t = samples.shape[1]
    valid = masked.length_mask(lengths, t)
    xm = jnp.where(valid, samples, 0.0)
    peak = jnp.max(jnp.abs(xm), axis=-1)
    n = jnp.maximum(lengths, 1).astype(samples.dtype)
    rms = jnp.sqrt(jnp.sum(xm * xm, axis=-1) / n)
    peak_db = jnp.where(peak > EPSILON, 20.0 * jnp.log10(jnp.maximum(peak, EPSILON)), -jnp.inf)

    target_peak_linear = 10.0 ** ((0.0 - max_headroom_db) / 20.0)

    if method == NormalizationMethod.PEAK:
        gain = jnp.where(peak > EPSILON, target_peak_linear / jnp.maximum(peak, EPSILON), 1.0)
        # reference: gain = min(gain, 1/peak) (normalization.rs:295)
        gain = jnp.minimum(gain, 1.0 / jnp.maximum(peak, EPSILON))
        gain = jnp.where(peak > EPSILON, gain, 1.0)
        measured_lufs = jnp.full_like(peak, -jnp.inf)
    elif method == NormalizationMethod.RMS:
        # LUFS -> approximate RMS dB (normalization.rs:536-538)
        target_rms_db = target_loudness_lufs + 3.0
        target_rms_linear = 10.0 ** ((target_rms_db - max_headroom_db) / 20.0)
        gain = jnp.where(rms > EPSILON, target_rms_linear / jnp.maximum(rms, EPSILON), 1.0)
        # clip protection: limit so peak*gain <= 1 (normalization.rs:362-379)
        clip = peak * gain > 1.0
        gain = jnp.where(clip, 1.0 / jnp.maximum(peak, EPSILON), gain)
        gain = jnp.where(rms > EPSILON, gain, 1.0)
        measured_lufs = jnp.full_like(peak, -jnp.inf)
    elif method == NormalizationMethod.LOUDNESS:
        measured_lufs = calculate_lufs(samples, lengths, sample_rate, bf16=bf16)
        gain_db = target_loudness_lufs - measured_lufs
        gain = 10.0 ** (gain_db / 20.0)
        # headroom-preserving clip protection (normalization.rs:430-456)
        over = peak * gain > target_peak_linear
        gain = jnp.where(over, target_peak_linear / jnp.maximum(peak, EPSILON), gain)
        # fall back to peak normalization when LUFS is -inf (silence)
        peak_gain = jnp.minimum(
            target_peak_linear / jnp.maximum(peak, EPSILON), 1.0 / jnp.maximum(peak, EPSILON)
        )
        gain = jnp.where(jnp.isfinite(measured_lufs), gain, peak_gain)
        gain = jnp.where(peak > EPSILON, gain, 1.0)
    else:  # pragma: no cover - exhaustive enum
        raise ValueError(f"unknown normalization method {method}")

    out = jnp.where(valid, samples * gain[:, None], 0.0)
    rms_out = jnp.sqrt(jnp.sum(out * out, axis=-1) / n)
    meta = {
        "peak_db": peak_db,
        "rms_db": jnp.where(rms_out > EPSILON, 20.0 * jnp.log10(jnp.maximum(rms_out, EPSILON)), -jnp.inf),
        "gain_db": 20.0 * jnp.log10(jnp.maximum(gain, EPSILON)),
        "measured_lufs": measured_lufs,
    }
    return out, meta
