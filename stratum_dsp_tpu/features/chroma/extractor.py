"""Chroma / HPCP extraction and key-path spectrogram conditioning.

Batched re-design of reference ``chroma/extractor.rs``:

* **Chroma mapping is a matmul**: the bin -> pitch-class circular-Gaussian
  soft mapping (extractor.rs:393-487) is a fixed ``[K, 12]`` projection for a
  given (sample_rate, fft_size, sigma, tuning); chroma = compressed-mags @ W
  as one matmul, then per-frame L2.
* **HPCP is vectorized peak algebra** (extractor.rs:556-680): local-max mask
  -> ``lax.top_k`` peaks -> harmonic fan-out (K_top × H × 3 pitch-class
  neighbors) -> one-hot scatter into 12 bins.
* **Conditioning** (extractor.rs:1246-1501): time smoothing and the harmonic
  soft time-mask are windowed means over ±margin frames (cumsum differences);
  the heavier median-filter HPSS mask runs on the time-downsampled,
  band-limited spectrogram exactly like the reference.
* **Tuning estimation** (extractor.rs:66-170): weighted circular mean of
  semitone residuals, a pure masked reduction.
* **Log-frequency** (extractor.rs:701-807): linear->semitone-bin conversion
  is another static projection matrix.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .postprocess import l2_normalize_chroma, l2_normalize_zero

EPSILON = 1e-10
A4_FREQ = 440.0
SEMITONE_OFFSET = 57.0
CHROMA_FMIN_HZ = 100.0
CHROMA_FMAX_HZ = 5000.0


def bin_freqs(sample_rate: int, fft_size: int, n_bins: int) -> np.ndarray:
    return np.arange(n_bins) * (sample_rate / fft_size)


def semitones_of_bins(sample_rate: int, fft_size: int, n_bins: int) -> np.ndarray:
    f = np.maximum(bin_freqs(sample_rate, fft_size, n_bins), 1e-6)
    return 12.0 * np.log2(f / A4_FREQ) + SEMITONE_OFFSET


@functools.lru_cache(maxsize=32)
def chroma_projection_matrix(
    sample_rate: int,
    fft_size: int,
    soft_mapping: bool,
    sigma: float,
    tuning_offset: float = 0.0,
    fmin_hz: float = CHROMA_FMIN_HZ,
    fmax_hz: float = CHROMA_FMAX_HZ,
) -> np.ndarray:
    """Static ``[K, 12]`` bin->pitch-class projection (extractor.rs:393-487):
    band-limit, circular-Gaussian soft mapping over the 3 nearest classes (or
    hard assignment). Applied to magnitudes already compressed by ^0.6."""
    n_bins = fft_size // 2 + 1
    freqs = bin_freqs(sample_rate, fft_size, n_bins)
    semis = semitones_of_bins(sample_rate, fft_size, n_bins) - tuning_offset
    w = np.zeros((n_bins, 12), dtype=np.float32)
    in_band = (freqs >= fmin_hz) & (freqs <= min(fmax_hz, sample_rate / 2)) & (
        freqs < sample_rate / 2
    )
    pc = np.mod(semis, 12.0)
    primary = np.mod(np.round(pc), 12).astype(np.int64)
    if soft_mapping:
        sig = max(sigma, 1e-6)
        for off in (-1, 0, 1):
            cls = np.mod(primary + off, 12)
            dist = np.abs(pc - cls)
            dist = np.minimum(dist, 12.0 - dist)
            wt = np.exp(-dist * dist / (2.0 * sig * sig)) * in_band
            np.add.at(w, (np.arange(n_bins), cls), wt)
    else:
        np.add.at(w, (np.arange(n_bins), primary), in_band.astype(np.float32))
    return w


def chroma_projection_dynamic(
    sample_rate: int,
    fft_size: int,
    soft_mapping: bool,
    sigma: float,
    tuning_offset: jax.Array,
    fmin_hz: float = CHROMA_FMIN_HZ,
    fmax_hz: float = CHROMA_FMAX_HZ,
) -> jax.Array:
    """Per-track ``[B, K, 12]`` projection for traced tuning offsets [B]
    (the tuning-compensated variant of :func:`chroma_projection_matrix`)."""
    n_bins = fft_size // 2 + 1
    freqs = bin_freqs(sample_rate, fft_size, n_bins)
    semis = jnp.asarray(semitones_of_bins(sample_rate, fft_size, n_bins), jnp.float32)
    in_band = jnp.asarray(
        (freqs >= fmin_hz)
        & (freqs <= min(fmax_hz, sample_rate / 2))
        & (freqs < sample_rate / 2),
        jnp.float32,
    )
    pc = jnp.mod(semis[None, :] - tuning_offset[:, None], 12.0)  # [B, K]
    primary = jnp.mod(jnp.round(pc), 12.0)
    sig = max(sigma, 1e-6)
    w = jnp.zeros((tuning_offset.shape[0], n_bins, 12), jnp.float32)
    offsets = (-1.0, 0.0, 1.0) if soft_mapping else (0.0,)
    for off in offsets:
        cls = jnp.mod(primary + off, 12.0)
        if soft_mapping:
            dist = jnp.abs(pc - cls)
            dist = jnp.minimum(dist, 12.0 - dist)
            wt = jnp.exp(-dist * dist / (2.0 * sig * sig)) * in_band
        else:
            wt = in_band * jnp.ones_like(pc)
        w = w + jax.nn.one_hot(cls.astype(jnp.int32), 12) * wt[..., None]
    return w


def frames_to_chroma(
    spec: jax.Array, projection: jax.Array, mag_compression: float = 0.6
) -> jax.Array:
    """Chroma [..., 12] from magnitudes [..., K]: compress, project, L2."""
    m = jnp.power(jnp.maximum(spec, 0.0), mag_compression)
    ch = jnp.matmul(m, projection, preferred_element_type=jnp.float32)
    return l2_normalize_zero(ch)


# --------------------------------------------------------------------------
# HPCP
# --------------------------------------------------------------------------


def spectral_whiten(spec: jax.Array, smooth_bins: int) -> jax.Array:
    """Per-frame moving-average whitening (extractor.rs:556-580): divide by
    the local mean over an odd window, clip at 20."""
    win = max(smooth_bins, 3) | 1
    half = win // 2
    x = jnp.maximum(spec, 0.0)
    c = jnp.cumsum(x, axis=-1)
    c0 = jnp.concatenate([jnp.zeros_like(c[..., :1]), c], axis=-1)
    n = spec.shape[-1]
    idx = np.arange(n)
    lo = np.maximum(idx - half, 0)
    hi = np.minimum(idx + half, n - 1)
    mean = (jnp.take(c0, hi + 1, axis=-1) - jnp.take(c0, lo, axis=-1)) / jnp.asarray(
        (hi - lo + 1).astype(np.float32)
    )
    return jnp.minimum(x / (mean + 1e-12), 20.0)


@functools.lru_cache(maxsize=32)
def hpcp_harmonic_matrix(
    sample_rate: int,
    fft_size: int,
    hi_bin: int,
    sigma: float,
    tuning_offset: float,
    num_harmonics: int,
    harmonic_decay: float,
    fmin: float,
    fmax: float,
) -> np.ndarray:
    """Static ``[hi_bin, 12]`` harmonic-summation projection: column c of row
    k is the total weight a *selected peak at bin k* contributes to pitch
    class c across all harmonics and the 3 circular-Gaussian neighbors
    (extractor.rs:582-680). Because the fan-out depends only on the bin
    index (f0 = k * fres), the whole per-peak harmonic algebra collapses to
    ``masked_peak_weights @ M`` — one matmul instead of per-frame
    gathers + transcendentals + one-hot scatters."""
    fres = sample_rate / fft_size
    m = np.zeros((hi_bin, 12), dtype=np.float32)
    sig = max(sigma, 1e-6)
    decay = float(np.clip(harmonic_decay, 0.0, 1.0))
    f0 = np.arange(hi_bin) * fres  # [K]
    h = np.arange(1, max(num_harmonics, 1) + 1, dtype=np.float64)  # [H]
    fh = f0[:, None] * h  # [K, H]
    h_ok = (fh >= fmin) & (fh <= fmax) & (f0[:, None] > 0.0)
    hw = (decay ** (h - 1.0)) / h
    semis = 12.0 * np.log2(np.maximum(fh, 1e-6) / A4_FREQ) + SEMITONE_OFFSET
    semis = semis - tuning_offset
    pc = np.mod(semis, 12.0)
    primary = np.mod(np.round(pc), 12.0)
    for off in (-1.0, 0.0, 1.0):
        cls = np.mod(primary + off, 12.0)
        dist = np.abs(pc - cls)
        dist = np.minimum(dist, 12.0 - dist)
        wt = np.exp(-dist * dist / (2.0 * sig * sig)) * hw * h_ok
        ci = cls.astype(np.int64)
        np.add.at(m, (np.repeat(np.arange(hi_bin), h.shape[0]), ci.ravel()), wt.ravel())
    return m


def hpcp_harmonic_matrix_dynamic(
    sample_rate: int,
    fft_size: int,
    hi_bin: int,
    sigma: float,
    tuning_offset: jax.Array,
    num_harmonics: int,
    harmonic_decay: float,
    fmin: float,
    fmax: float,
) -> jax.Array:
    """Traced-tuning variant of :func:`hpcp_harmonic_matrix`: returns
    ``[..., hi_bin, 12]`` with leading dims broadcast from ``tuning_offset``
    (per-track offsets give ``[B, hi_bin, 12]``). Cost is O(B*K*H) once per
    call — negligible next to the per-frame work it replaces."""
    fres = sample_rate / fft_size
    sig = max(sigma, 1e-6)
    decay = float(np.clip(harmonic_decay, 0.0, 1.0))
    f0 = np.arange(hi_bin) * fres
    h = np.arange(1, max(num_harmonics, 1) + 1, dtype=np.float64)
    fh = f0[:, None] * h  # [K, H]
    h_ok = jnp.asarray((fh >= fmin) & (fh <= fmax) & (f0[:, None] > 0.0), jnp.float32)
    hw = jnp.asarray((decay ** (h - 1.0)) / h, jnp.float32)
    semis_np = 12.0 * np.log2(np.maximum(fh, 1e-6) / A4_FREQ) + SEMITONE_OFFSET
    t = jnp.asarray(tuning_offset, jnp.float32)
    semis = jnp.asarray(semis_np, jnp.float32) - t[..., None, None]
    pc = jnp.mod(semis, 12.0)  # [..., K, H]
    primary = jnp.mod(jnp.round(pc), 12.0)
    out = jnp.zeros(pc.shape[:-2] + (hi_bin, 12), jnp.float32)
    for off in (-1.0, 0.0, 1.0):
        cls = jnp.mod(primary + off, 12.0)
        dist = jnp.abs(pc - cls)
        dist = jnp.minimum(dist, 12.0 - dist)
        wt = jnp.exp(-dist * dist / (2.0 * sig * sig)) * hw * h_ok  # [..., K, H]
        onehot = jax.nn.one_hot(cls.astype(jnp.int32), 12, dtype=jnp.float32)
        out = out + jnp.sum(wt[..., None] * onehot, axis=-2)
    return out


def frames_to_hpcp(
    spec: jax.Array,
    sample_rate: int,
    fft_size: int,
    sigma: float,
    tuning_offset,
    peaks_per_frame: int,
    num_harmonics: int,
    harmonic_decay: float,
    mag_power: float,
    enable_whitening: bool = False,
    whitening_smooth_bins: int = 31,
    fmin_hz: float = CHROMA_FMIN_HZ,
    fmax_hz: float = CHROMA_FMAX_HZ,
    approx_peaks: bool = True,
) -> jax.Array:
    """HPCP [..., 12] from magnitudes [..., K] (frame_to_hpcp_tuned_band,
    extractor.rs:528-680). ``tuning_offset`` may be a traced scalar (it only
    shifts semitone positions). ``approx_peaks`` selects the top-K peak SET
    with a threshold search instead of an exact sort —
    harmonic summation is order-independent, so only the membership of
    borderline peaks can differ (recall >= ~0.95 per k)."""
    n_bins = spec.shape[-1]
    freqs_full = bin_freqs(sample_rate, fft_size, n_bins)
    fmin = max(fmin_hz, 20.0)
    fmax = min(fmax_hz, sample_rate / 2)
    if fmax <= fmin:
        return jnp.zeros(spec.shape[:-1] + (12,), jnp.float32)

    # Slice to the band before peak-picking: peaks AND their usable harmonics
    # all live in [fmin, fmax] (frame_to_hpcp_tuned_band breaks at fmax), so
    # the top_k (which XLA lowers to a full sort) runs over ~900 bins instead
    # of 4097 — the dominant cost of the key path otherwise.
    hi_bin = min(int(np.ceil(fmax / (sample_rate / fft_size))) + 2, n_bins)
    spec_b = spec[..., :hi_bin]
    freqs = freqs_full[:hi_bin]

    sel = spectral_whiten(spec_b, whitening_smooth_bins) if (
        enable_whitening and whitening_smooth_bins >= 3
    ) else spec_b
    prev = jnp.concatenate([sel[..., :1], sel[..., :-1]], axis=-1)
    nxt = jnp.concatenate([sel[..., 1:], sel[..., -1:]], axis=-1)
    # interior of the FULL spectrum: bins 1..n_bins-2 (the slice keeps bin
    # hi_bin-1 interior because hi_bin includes padding above fmax)
    interior = (np.arange(hi_bin) >= 1) & (np.arange(hi_bin) < n_bins - 1)
    in_band = (freqs >= fmin) & (freqs <= fmax)
    peak_ok = jnp.asarray(interior & in_band) & (sel > prev) & (sel >= nxt)

    k_top = max(min(peaks_per_frame, hi_bin), 1)
    peak_vals = jnp.where(peak_ok, sel, -jnp.inf)
    raw_b = jnp.maximum(spec_b, 0.0)  # top_idx < hi_bin, so spec_b == spec here
    p = float(np.clip(mag_power, 0.05, 1.0))
    half_w = (hi_bin + 1) // 2

    if approx_peaks and k_top <= half_w:
        # Threshold formulation: bisect for tau ~= the k-th largest peak
        # value (12 fused count-compare passes, cheaper inside the streamed
        # reducer than approx_max_k or a full sort), select every peak >= tau by MASK, and collapse the
        # whole per-peak harmonic fan-out (gathers + per-frame log2/mod/exp
        # + one-hot scatters) into ONE [.., hi_bin] @ [hi_bin, 12]
        # matmul against the precomputed harmonic projection. tau converges
        # to within vmax/2^20 below the true k-th value, so the selected
        # set is the exact top-k plus any peaks tied within that sliver
        # (harmless: harmonic summation is monotone in peak count).
        vmax = jnp.max(jnp.where(peak_ok, sel, 0.0), axis=-1, keepdims=True)
        lo = jnp.zeros_like(vmax)
        hi = vmax
        for _ in range(20):
            mid = 0.5 * (lo + hi)
            cnt = jnp.sum((peak_vals >= mid) & peak_ok, axis=-1, keepdims=True)
            take_lower = cnt < k_top
            hi = jnp.where(take_lower, mid, hi)
            lo = jnp.where(take_lower, lo, mid)
        # count(>= lo) >= k_top >= count(>= hi): lo never drops a true
        # top-k peak; when fewer than k_top peaks exist lo stays 0 and
        # every peak is kept (matching top_k over all finite entries)
        mask = peak_ok & (peak_vals >= lo)
        w_bins = jnp.where(
            mask, jnp.sqrt(raw_b) if p == 0.5 else jnp.power(raw_b, p), 0.0
        )
        if isinstance(tuning_offset, (int, float)):
            m = jnp.asarray(hpcp_harmonic_matrix(
                sample_rate, fft_size, hi_bin, sigma, float(tuning_offset),
                num_harmonics, harmonic_decay, fmin, fmax,
            ))
        else:
            m = hpcp_harmonic_matrix_dynamic(
                sample_rate, fft_size, hi_bin, sigma, tuning_offset,
                num_harmonics, harmonic_decay, fmin, fmax,
            )
        out = jnp.matmul(w_bins, m, preferred_element_type=jnp.float32)
        return l2_normalize_zero(out)

    # Exact path (approx_peaks=False): reference-faithful top-k selection.
    # Sorting (vals, raw, bin) jointly replaces top_k + a take_along_axis
    # gather — the combination was the hottest op pair of the key path
    # before the threshold/matmul path above became the default.
    if hi_bin % 2:
        peak_vals = jnp.pad(peak_vals, [(0, 0)] * (peak_vals.ndim - 1) + [(0, 1)],
                            constant_values=-jnp.inf)
        raw_b = jnp.pad(raw_b, [(0, 0)] * (raw_b.ndim - 1) + [(0, 1)])
    bin_ids = jnp.broadcast_to(
        jnp.arange(2 * half_w, dtype=jnp.int32), peak_vals.shape
    )
    ev, od = peak_vals[..., 0::2], peak_vals[..., 1::2]
    take_odd = od > ev  # tie -> even (lower bin), matching stable top_k
    pv2 = jnp.where(take_odd, od, ev)
    id2 = jnp.where(take_odd, bin_ids[..., 1::2], bin_ids[..., 0::2])

    if k_top <= half_w:
        # exact: 2-operand sort (value key + packed bin id), raw gathered
        # after — sorting the third operand alongside measured slower
        s_neg, s_idx = jax.lax.sort(
            (-pv2, id2), dimension=-1, num_keys=1, is_stable=True
        )
        top_vals = -s_neg[..., :k_top]
        top_idx = s_idx[..., :k_top]
        # id2 indexes the PRE-halved axis; raw2 is indexed by halved position,
        # so recover raw from the full-width padded raw_b instead
        raw_at_peak = jnp.take_along_axis(raw_b, top_idx, axis=-1)
    else:  # degenerate tiny-band case: keep the straightforward path
        top_vals, top_idx = jax.lax.top_k(peak_vals[..., :hi_bin], k_top)
        raw_at_peak = jnp.take_along_axis(raw_b, top_idx, axis=-1)
    valid = jnp.isfinite(top_vals)
    w0 = jnp.where(valid, jnp.power(raw_at_peak, p), 0.0)

    fres = sample_rate / fft_size
    f0 = top_idx.astype(jnp.float32) * fres  # [..., k_top]
    h = jnp.arange(1, max(num_harmonics, 1) + 1, dtype=jnp.float32)  # [H]
    fh = f0[..., None] * h  # [..., k_top, H]
    h_ok = (fh >= fmin) & (fh <= fmax) & (f0[..., None] > 0.0)

    decay = float(np.clip(harmonic_decay, 0.0, 1.0))
    hw = (decay ** (h - 1.0)) / h  # [H]
    contrib = w0[..., None] * hw * h_ok  # [..., k_top, H]

    semis = 12.0 * jnp.log2(jnp.maximum(fh, 1e-6) / A4_FREQ) + SEMITONE_OFFSET
    if not isinstance(tuning_offset, (int, float)):
        # per-track offsets broadcast from the LEFT (batch-leading), never
        # against the trailing [k_top, H] axes
        t = jnp.asarray(tuning_offset, jnp.float32)
        tuning_offset = t.reshape(t.shape + (1,) * (semis.ndim - t.ndim))
    semis = semis - tuning_offset
    pc = jnp.mod(semis, 12.0)
    primary = jnp.mod(jnp.round(pc), 12.0)
    sig = max(sigma, 1e-6)

    out = jnp.zeros(spec.shape[:-1] + (12,), jnp.float32)
    for off in (-1.0, 0.0, 1.0):
        cls = jnp.mod(primary + off, 12.0)
        dist = jnp.abs(pc - cls)
        dist = jnp.minimum(dist, 12.0 - dist)
        wt = jnp.exp(-dist * dist / (2.0 * sig * sig)) * contrib
        onehot = jax.nn.one_hot(cls.astype(jnp.int32), 12, dtype=jnp.float32)
        out = out + jnp.sum(wt[..., None] * onehot, axis=(-3, -2))
    return l2_normalize_zero(out)


# --------------------------------------------------------------------------
# Conditioning
# --------------------------------------------------------------------------


def _box_band_matrix(t: int, margin: int) -> jax.Array:
    """[t, t] 0/1 band matrix: W[s, u] = 1 iff |s - u| <= margin. Built from
    iota on device so it never becomes a multi-MB HLO literal."""
    s = jax.lax.broadcasted_iota(jnp.int32, (t, t), 0)
    u = jax.lax.broadcasted_iota(jnp.int32, (t, t), 1)
    return (jnp.abs(s - u) <= margin).astype(jnp.float32)


def windowed_time_mean(spec: jax.Array, fvalid: jax.Array, margin: int) -> jax.Array:
    """Mean over frames [t-margin, t+margin] counting only valid frames
    (smooth_spectrogram_time, extractor.rs:1246-1290). ``spec [..., T, K]``
    with invalid frames zeroed, ``fvalid [..., T]``.

    The box sum runs as one banded matmul (a frame-axis cumsum costs
    O(log T) passes over the stream; re-tiling into 128-frame
    margin-extended tiles to shave the ~97%-zero band copies more than it
    saves). HIGH is TF32 on the GPU (~1e-3 relative on each input), f32 on
    the CPU; the counts are exact either way."""
    if margin <= 0:
        return spec
    t = spec.shape[-2]
    w = _box_band_matrix(t, margin)
    sums = jnp.einsum(
        "...tk,st->...sk", spec, w,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGH,
    )
    cnts = jnp.einsum(
        "...t,st->...s", fvalid.astype(jnp.float32), w,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGH,
    )
    return sums / jnp.maximum(cnts, 1.0)[..., None]


def harmonic_time_mask(
    spec: jax.Array, fvalid: jax.Array, margin: int, mask_power: float
) -> jax.Array:
    """Soft harmonic mask H = X * h^p/(h^p + max(0, X-h)^p + eps)
    (harmonic_spectrogram_time_mask, extractor.rs:1306-1349)."""
    x = jnp.maximum(spec, 0.0)
    h = jnp.maximum(windowed_time_mean(x, fvalid, margin), 0.0)
    r = jnp.maximum(x - h, 0.0)
    p = max(mask_power, 1.0)
    if p == 2.0:  # default: keep it on the VPU's mul path, not pow
        hp, rp = h * h, r * r
    else:
        hp, rp = jnp.power(h, p), jnp.power(r, p)
    return x * (hp / (hp + rp + 1e-12))


def hpss_median_mask_downsampled(
    band_spec_ds: jax.Array,
    ds_counts: jax.Array,
    time_margin: int,
    freq_margin: int,
    mask_power: float,
) -> jax.Array:
    """Harmonic soft mask on the downsampled band spectrogram
    (harmonic_spectrogram_hpss_median_mask, extractor.rs:1369-1501):
    select_nth (index len/2) medians across time and frequency, then
    M = h^p/(h^p + per^p + eps). ``band_spec_ds [B, n_ds, band]``,
    ``ds_counts [B]`` valid downsampled frames."""
    from .postprocess import _median_select_nth_masked

    b, n_ds, band = band_spec_ds.shape
    x = jnp.maximum(band_spec_ds, 0.0)
    # time medians: [B, band, n_ds]
    xt = jnp.swapaxes(x, 1, 2)
    h = jnp.swapaxes(
        _median_select_nth_masked(xt, ds_counts[:, None], time_margin), 1, 2
    )
    per = _median_select_nth_masked(x, jnp.full((b, 1), band), freq_margin)
    p = max(mask_power, 1.0)
    hp = jnp.power(jnp.maximum(h, 0.0), p)
    pp = jnp.power(jnp.maximum(per, 0.0), p)
    return hp / (hp + pp + 1e-12)


# --------------------------------------------------------------------------
# Tuning estimation
# --------------------------------------------------------------------------


def estimate_tuning_offset(
    spec: jax.Array,
    fvalid: jax.Array,
    sample_rate: int,
    fft_size: int,
    fmin_hz: float,
    fmax_hz: float,
    frame_step: int,
    peak_rel_threshold: float,
) -> jax.Array:
    """Weighted circular mean of semitone residuals (extractor.rs:66-170).

    ``spec [B, T, K]`` (invalid frames zeroed), returns offsets [B] in
    [-0.5, 0.5); 0 when residuals aren't concentrated (r < 0.05).
    """
    b, t, n_bins = spec.shape
    freqs = bin_freqs(sample_rate, fft_size, n_bins)
    fmin = max(fmin_hz, 20.0)
    fmax = float(np.clip(fmax_hz, fmin + 1.0, sample_rate / 2))
    in_band = jnp.asarray((freqs >= fmin) & (freqs <= fmax))
    step_mask = jnp.asarray((np.arange(t) % max(frame_step, 1)) == 0)
    use_frame = fvalid & step_mask[None, :]

    x = jnp.maximum(spec, 0.0) * in_band
    peak = jnp.max(x, axis=-1, keepdims=True)
    thr = peak * float(np.clip(peak_rel_threshold, 0.0, 1.0))
    sel = use_frame[..., None] & (x >= thr) & (peak > 1e-12) & in_band

    semis = jnp.asarray(semitones_of_bins(sample_rate, fft_size, n_bins), jnp.float32)
    residual = semis - jnp.round(semis)
    w = jnp.where(sel, jnp.sqrt(x), 0.0)
    angle = 2.0 * jnp.pi * residual
    sum_sin = jnp.sum(w * jnp.sin(angle), axis=(-2, -1))
    sum_cos = jnp.sum(w * jnp.cos(angle), axis=(-2, -1))
    sum_w = jnp.sum(w, axis=(-2, -1))
    r = jnp.sqrt(sum_sin**2 + sum_cos**2) / jnp.maximum(sum_w, 1e-6)
    delta = jnp.arctan2(sum_sin, sum_cos) / (2.0 * jnp.pi)
    return jnp.where((sum_w > 1e-6) & (r >= 0.05), delta, 0.0)


# --------------------------------------------------------------------------
# Log-frequency projection
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def log_frequency_projection(
    sample_rate: int, fft_size: int, fmin_hz: float, fmax_hz: float
) -> Tuple[np.ndarray, int]:
    """Static ``[K, n_semitone_bins]`` linear->log-frequency interpolation
    matrix + the semitone index of bin 0 (extractor.rs:701-807)."""
    n_bins = fft_size // 2 + 1
    nyquist = sample_rate / 2
    fmin = max(fmin_hz, 20.0)
    fmax = min(fmax_hz, nyquist - 1.0)
    s_min = 12.0 * np.log2(fmin / A4_FREQ) + SEMITONE_OFFSET
    s_max = 12.0 * np.log2(fmax / A4_FREQ) + SEMITONE_OFFSET
    bin_min = int(np.floor(s_min))
    bin_max = int(np.ceil(s_max))
    n_out = bin_max - bin_min + 1

    freqs = bin_freqs(sample_rate, fft_size, n_bins)
    w = np.zeros((n_bins, n_out), dtype=np.float32)
    ok = (freqs >= fmin) & (freqs < fmax) & (freqs < nyquist)
    semis = 12.0 * np.log2(np.maximum(freqs, 1e-6) / A4_FREQ) + SEMITONE_OFFSET
    pos = semis - bin_min
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(np.ceil(pos).astype(np.int64), n_out - 1)
    w_hi = pos - lo
    for k in range(n_bins):
        if not ok[k] or lo[k] >= n_out or lo[k] < 0:
            continue
        w[k, lo[k]] += 1.0 - w_hi[k]
        if hi[k] != lo[k]:
            w[k, hi[k]] += w_hi[k]
    return w, bin_min


@functools.lru_cache(maxsize=8)
def semitone_fold_matrix(n_semitone_bins: int, semitone_offset: int) -> np.ndarray:
    """[n_semitone_bins, 12] mod-12 fold (extract_chroma_from_log_frequency_
    spectrogram, extractor.rs:937-981)."""
    w = np.zeros((n_semitone_bins, 12), dtype=np.float32)
    for i in range(n_semitone_bins):
        w[i, (semitone_offset + i) % 12] = 1.0
    return w


# --------------------------------------------------------------------------
# Beat-synchronous chroma
# --------------------------------------------------------------------------


def beat_synchronous_chroma(
    frame_chroma: jax.Array,
    frame_energy: jax.Array,
    fvalid: jax.Array,
    beat_times: jax.Array,
    beat_valid: jax.Array,
    frame_rate: float,
):
    """Average per-frame chroma within beat intervals
    (extract_beat_synchronous_chroma, extractor.rs:830-922).

    Returns (chroma [B, NB-1, 12], energy [B, NB-1], interval_valid
    [B, NB-1]) where interval i spans beats i..i+1. Empty intervals produce
    zero chroma like the reference.
    """
    b, t, _ = frame_chroma.shape
    nb = beat_times.shape[-1]
    frame_time = jnp.arange(t, dtype=jnp.float32) / frame_rate  # [T]
    bt = jnp.where(beat_valid, beat_times, jnp.inf)

    def per_row(bt_row, fv):
        # segment id: frames before beat 0 -> 0 (masked off), else interval
        seg = jnp.searchsorted(bt_row, frame_time, side="right") - 1  # [T]
        ok = (seg >= 0) & (seg < nb - 1) & fv
        seg = jnp.clip(seg, 0, nb - 2)
        return seg, ok

    seg, ok = jax.vmap(per_row)(bt, fvalid)

    def seg_sum(vals, ids):
        return jax.vmap(lambda v, i: jax.ops.segment_sum(v, i, num_segments=nb - 1))(vals, ids)

    okf = ok.astype(jnp.float32)
    counts = seg_sum(okf, seg)
    ch_sum = jax.vmap(
        lambda v, i: jax.ops.segment_sum(v, i, num_segments=nb - 1)
    )(frame_chroma * okf[..., None], seg)
    en_sum = seg_sum(frame_energy * okf, seg)

    avg = ch_sum / jnp.maximum(counts, 1.0)[..., None]
    avg = jnp.where(counts[..., None] > 0, l2_normalize_zero(avg), 0.0)
    n_beats = jnp.sum(beat_valid, axis=-1)
    interval_valid = jnp.arange(nb - 1)[None, :] < jnp.maximum(n_beats - 1, 0)[:, None]
    return avg, en_sum, interval_valid & (counts > 0)
