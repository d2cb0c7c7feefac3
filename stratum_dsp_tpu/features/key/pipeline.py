"""Key-detection path: streamed key STFT -> conditioning -> chroma/HPCP ->
frame weighting -> detection.

Mirror of the orchestrator's key block (lib.rs:961-1559). The key STFT
(default 8192/512, config.rs:686-689) streams in frame chunks
with a ±margin halo so the harmonic time-mask / time smoothing see their full
context; each chunk emits only [B, C, 12] chroma + [B, C] energies.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import AnalysisConfig
from ...ops import masked
from ...ops.stft import stft_reduce
from ..chroma import extractor as chx
from ..chroma.postprocess import sharpen_chroma, smooth_chroma_median
from . import detector
from .detector import KeyResult

EPSILON = 1e-12

# Frame-chunk element budget for the streamed key STFT: bounds the
# [B, chunk, frame_size] frames buffer so large batches don't OOM, while
# keeping chunks big enough that the scan does not serialize the device.
# The value was tuned on the previous accelerator and is untuned on the
# H100; the knee follows the TOTAL working set B*chunk*frame, not the chunk
# size alone.
CHUNK_ELEMENT_BUDGET = 60_000_000


def _auto_chunk(b: int, frame_size: int, requested: int) -> int:
    cap = max(CHUNK_ELEMENT_BUDGET // max(b * frame_size, 1), 128)
    return int(min(requested, cap))


def _condition_chunk(spec, fvalid, cfg: AnalysisConfig, halo: int):
    """Apply the configured conditioning to an extended chunk; the caller
    slices out the central frames afterwards (lib.rs:1012-1062)."""
    # windowed_time_mean's box sums require invalid frames ZEROED (its
    # count denominator already excludes them). stft_reduce zeroes them at
    # the chunk boundary today; this re-zeroing makes the contract local so
    # a future reducer/caller cannot silently violate it (the round-5 halo
    # misalignment hid behind exactly this kind of implicit invariant).
    spec = jnp.where(fvalid[..., None], spec, 0.0)
    if cfg.enable_key_harmonic_mask and not cfg.enable_key_hpss_harmonic:
        return chx.harmonic_time_mask(
            spec, fvalid, cfg.key_spectrogram_smooth_margin, cfg.key_harmonic_mask_power
        )
    if cfg.enable_key_spectrogram_time_smoothing and not cfg.enable_key_hpss_harmonic:
        return chx.windowed_time_mean(spec, fvalid, cfg.key_spectrogram_smooth_margin)
    return spec


def _key_keep_bins(cfg: AnalysisConfig, sample_rate: int, frame_size: int):
    """Bins materialized by the key STFT: chroma/HPCP only read
    [100, 5000] Hz (extractor.rs:47-48), so the streamed pass keeps bins
    [0, ceil(5000 Hz) + 2) — ~930 of 4097 at 8192/44.1k. This is an
    approximation in ONE place: the per-frame energy used for
    frame weighting (lib.rs:1256-1287) sums the conditioned band instead of
    the full spectrum; the weights are median-normalized so only the
    (small, mostly-percussive) >5 kHz share is lost. The log-frequency
    path keeps all bins."""
    if cfg.enable_key_log_frequency:
        return None
    n_bins = frame_size // 2 + 1
    fres = sample_rate / frame_size
    return int(min(np.ceil(5000.0 / fres) + 2, n_bins))


def _key_stft_params(cfg: AnalysisConfig):
    frame_size = cfg.key_stft_frame_size if cfg.enable_key_stft_override else cfg.frame_size
    hop = cfg.key_stft_hop_size if cfg.enable_key_stft_override else cfg.hop_size
    return max(frame_size, 256), max(hop, 1)




def _stft_reduce_any(
    samples, lengths, frame_size, hop, reducer, carry_init, chunk_frames,
    halo, keep_bins, mesh, bf16=False,
):
    """Plain or time-sharded streamed STFT reduce (same contract/returns)."""
    if mesh is not None and "time" in mesh.shape:
        from ...parallel.timeblocks import stft_reduce_sharded

        return stft_reduce_sharded(
            samples, lengths, frame_size, hop, reducer, carry_init, mesh,
            prev_frames=0, halo_frames=halo, keep_bins=keep_bins,
            chunk_frames=chunk_frames, bf16=bf16,
        )
    return stft_reduce(
        samples, lengths, frame_size, hop, reducer, carry_init,
        chunk_frames=chunk_frames, halo=halo, keep_bins=keep_bins, bf16=bf16,
    )

def estimate_tuning_streamed(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    chunk_frames: int = 512,
    mesh=None,
) -> jax.Array:
    """Streamed tuning estimation over the *conditioned* key spectrogram
    (lib.rs:1090-1110): per-chunk partial circular sums, combined at the end.
    Returns per-track offsets [B] clamped to ±key_tuning_max_abs_semitones."""
    frame_size, hop = _key_stft_params(cfg)
    keep_bins = _key_keep_bins(cfg, sample_rate, frame_size)
    halo = (
        cfg.key_spectrogram_smooth_margin
        if (cfg.enable_key_harmonic_mask or cfg.enable_key_spectrogram_time_smoothing)
        and not cfg.enable_key_hpss_harmonic
        else 0
    )
    n_bins = keep_bins if keep_bins is not None else frame_size // 2 + 1
    freqs = chx.bin_freqs(sample_rate, frame_size, n_bins)
    fmin, fmax = 80.0, float(np.clip(2000.0, 81.0, sample_rate / 2))
    in_band = jnp.asarray((freqs >= fmin) & (freqs <= fmax))
    semis = jnp.asarray(
        chx.semitones_of_bins(sample_rate, frame_size, n_bins), jnp.float32
    )
    residual = semis - jnp.round(semis)
    angle = 2.0 * jnp.pi * residual
    step = max(cfg.key_tuning_frame_step, 1)
    thr_rel = float(np.clip(cfg.key_tuning_peak_rel_threshold, 0.0, 1.0))

    def reducer(spec, fidx, fvalid, carry):
        cond = _condition_chunk(spec, fvalid, cfg, halo)
        c = spec.shape[1] - 2 * halo
        central = jnp.maximum(cond[:, halo : halo + c, :], 0.0)
        cv = fvalid[:, halo : halo + c]
        cfidx = fidx[halo : halo + c]
        use_frame = cv & ((cfidx % step) == 0)[None, :]
        x = central * in_band
        peak = jnp.max(x, axis=-1, keepdims=True)
        sel = use_frame[..., None] & (x >= peak * thr_rel) & (peak > 1e-12) & in_band
        w = jnp.where(sel, jnp.sqrt(x), 0.0).astype(jnp.float32)
        outs = {
            "sin": jnp.sum(w * jnp.sin(angle), axis=-1),
            "cos": jnp.sum(w * jnp.cos(angle), axis=-1),
            "w": jnp.sum(w, axis=-1),
        }
        return outs, carry

    chunk_frames = _auto_chunk(samples.shape[0], frame_size, chunk_frames)
    outs, _, _ = _stft_reduce_any(
        samples, lengths, frame_size, hop, reducer, lambda b: jnp.zeros((b,)),
        chunk_frames, halo, keep_bins, mesh, bf16=cfg.stft_bf16,
    )
    s_sin = jnp.sum(outs["sin"], axis=-1)
    s_cos = jnp.sum(outs["cos"], axis=-1)
    s_w = jnp.sum(outs["w"], axis=-1)
    r = jnp.sqrt(s_sin**2 + s_cos**2) / jnp.maximum(s_w, 1e-6)
    delta = jnp.arctan2(s_sin, s_cos) / (2.0 * jnp.pi)
    delta = jnp.where((s_w > 1e-6) & (r >= 0.05), delta, 0.0)
    m = abs(cfg.key_tuning_max_abs_semitones)
    return jnp.clip(delta, -m, m)


def collect_hpss_mask(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    chunk_frames: int = 512,
    mesh=None,
):
    """Pass A of the key HPSS-median-mask path (extractor.rs:1369-1501):
    collect the time-downsampled band-limited spectrogram and compute the
    harmonic soft mask on it. Returns (mask_ds [B, n_ds, band], bin_start,
    bin_end, step)."""
    frame_size, hop = _key_stft_params(cfg)
    n_bins = frame_size // 2 + 1
    fres = sample_rate / frame_size
    fmin, fmax = 100.0, float(np.clip(5000.0, 101.0, sample_rate / 2))
    bin_start = int(np.clip(np.floor(fmin / fres), 0, n_bins))
    bin_end = int(np.clip(np.ceil(fmax / fres), 0, n_bins))
    step = max(cfg.key_hpss_frame_step, 1)

    def reducer(spec, fidx, fvalid, carry):
        # emit the full band per chunk (the reducer contract requires
        # [B, C, ...] outputs); time-downsampling happens post-materialize
        band = spec[:, :, bin_start:bin_end]
        return {"band": jnp.where(fvalid[..., None], band, 0.0)}, carry

    chunk_frames = _auto_chunk(samples.shape[0], frame_size, chunk_frames)
    outs, _, frame_counts = _stft_reduce_any(
        samples, lengths, frame_size, hop, reducer, lambda b: jnp.zeros((b,)),
        chunk_frames, 0, _key_keep_bins(cfg, sample_rate, frame_size), mesh,
        bf16=cfg.stft_bf16,
    )
    band_ds = outs["band"][:, ::step]
    ds_counts = -(-frame_counts // step)  # ceil: frames 0, step, 2*step, ...
    mask_ds = chx.hpss_median_mask_downsampled(
        band_ds, ds_counts, cfg.key_hpss_time_margin, cfg.key_hpss_freq_margin,
        cfg.key_hpss_mask_power,
    )
    return mask_ds, bin_start, bin_end, step


def extract_key_features(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    tuning_offset=0.0,
    hpss_mask=None,
    chunk_frames: int = 512,
    mesh=None,
):
    """Stream the key STFT and emit per-frame (chroma [B, F, 12],
    energy [B, F], frame_counts [B]).

    Handles the default conditioning paths inline; the HPSS-median-mask path
    passes the precomputed ``hpss_mask`` tuple from ``collect_hpss_mask``.
    ``tuning_offset`` may be a per-track traced array [B].
    """
    frame_size, hop = _key_stft_params(cfg)
    keep_bins = _key_keep_bins(cfg, sample_rate, frame_size)
    halo = (
        cfg.key_spectrogram_smooth_margin
        if (cfg.enable_key_harmonic_mask or cfg.enable_key_spectrogram_time_smoothing)
        and not cfg.enable_key_hpss_harmonic
        else 0
    )

    use_log_freq = cfg.enable_key_log_frequency
    static_tuning = isinstance(tuning_offset, (int, float))
    if use_log_freq:
        lproj, s_min = chx.log_frequency_projection(sample_rate, frame_size, 100.0, 5000.0)
        fold = chx.semitone_fold_matrix(lproj.shape[1], s_min)
        log_proj = jnp.asarray(lproj)
        fold_m = jnp.asarray(fold)
    elif not cfg.enable_key_hpcp:
        if static_tuning:
            proj = jnp.asarray(
                chx.chroma_projection_matrix(
                    sample_rate, frame_size, cfg.soft_chroma_mapping,
                    cfg.soft_mapping_sigma, float(tuning_offset),
                )
            )
        else:
            proj = chx.chroma_projection_dynamic(
                sample_rate, frame_size, cfg.soft_chroma_mapping,
                cfg.soft_mapping_sigma, tuning_offset,
            )  # [B, K, 12]
        if keep_bins is not None:
            proj = proj[..., :keep_bins, :]

    if hpss_mask is not None:
        mask_ds, bin_start, bin_end, mask_step = hpss_mask
        n_ds = mask_ds.shape[1]

    def reducer(spec, fidx, fvalid, carry):
        cond = _condition_chunk(spec, fvalid, cfg, halo)
        c = spec.shape[1] - 2 * halo
        central = cond[:, halo : halo + c, :]
        central_valid = fvalid[:, halo : halo + c]
        central = jnp.where(central_valid[..., None], central, 0.0)

        if hpss_mask is not None:
            # apply the downsampled harmonic mask; out-of-band bins zeroed
            # (extractor.rs:1478-1498)
            k_idx = jnp.clip(fidx[halo : halo + c] // mask_step, 0, n_ds - 1)
            m = jnp.take(mask_ds, k_idx, axis=1)  # [B, C, band]
            full_m = jnp.zeros(central.shape).at[..., bin_start:bin_end].set(m)
            central = jnp.maximum(central, 0.0) * full_m

        if use_log_freq:
            logspec = jnp.matmul(central, log_proj, preferred_element_type=jnp.float32)
            ch = jnp.matmul(logspec, fold_m, preferred_element_type=jnp.float32)
            from ..chroma.postprocess import l2_normalize_zero

            ch = jnp.where(
                jnp.sum(logspec, axis=-1, keepdims=True) > 0, l2_normalize_zero(ch), 0.0
            )
            energy = jnp.sum(logspec * logspec, axis=-1)
        elif cfg.enable_key_hpcp:
            if cfg.enable_key_hpcp_bass_blend:
                full = chx.frames_to_hpcp(
                    central, sample_rate, frame_size, cfg.soft_mapping_sigma, tuning_offset,
                    cfg.key_hpcp_peaks_per_frame, cfg.key_hpcp_num_harmonics,
                    cfg.key_hpcp_harmonic_decay, cfg.key_hpcp_mag_power,
                    cfg.enable_key_hpcp_whitening, cfg.key_hpcp_whitening_smooth_bins,
                    approx_peaks=cfg.key_hpcp_approx_peaks,
                )
                bass = chx.frames_to_hpcp(
                    central, sample_rate, frame_size, cfg.soft_mapping_sigma, tuning_offset,
                    int(np.clip(cfg.key_hpcp_peaks_per_frame, 1, 12)),
                    cfg.key_hpcp_num_harmonics, cfg.key_hpcp_harmonic_decay,
                    cfg.key_hpcp_mag_power, cfg.enable_key_hpcp_whitening,
                    cfg.key_hpcp_whitening_smooth_bins,
                    fmin_hz=cfg.key_hpcp_bass_fmin_hz, fmax_hz=cfg.key_hpcp_bass_fmax_hz,
                    approx_peaks=cfg.key_hpcp_approx_peaks,
                )
                w = float(np.clip(cfg.key_hpcp_bass_weight, 0.0, 1.0))
                from ..chroma.postprocess import l2_normalize_zero

                ch = l2_normalize_zero((1.0 - w) * full + w * bass)
            else:
                ch = chx.frames_to_hpcp(
                    central, sample_rate, frame_size, cfg.soft_mapping_sigma, tuning_offset,
                    cfg.key_hpcp_peaks_per_frame, cfg.key_hpcp_num_harmonics,
                    cfg.key_hpcp_harmonic_decay, cfg.key_hpcp_mag_power,
                    cfg.enable_key_hpcp_whitening, cfg.key_hpcp_whitening_smooth_bins,
                    approx_peaks=cfg.key_hpcp_approx_peaks,
                )
            ce = central.astype(jnp.float32)
            energy = jnp.sum(ce * ce, axis=-1)
        else:
            ch = chx.frames_to_chroma(central, proj)
            ce = central.astype(jnp.float32)
            energy = jnp.sum(ce * ce, axis=-1)

        ch = jnp.where(central_valid[..., None], ch, 0.0)
        energy = jnp.where(central_valid, energy, 0.0)
        return {"chroma": ch, "energy": energy}, carry

    chunk_frames = _auto_chunk(samples.shape[0], frame_size, chunk_frames)
    outs, nf_padded, frame_counts = _stft_reduce_any(
        samples, lengths, frame_size, hop, reducer, lambda b: jnp.zeros((b,)),
        chunk_frames, halo, keep_bins, mesh, bf16=cfg.stft_bf16,
    )
    return outs["chroma"], outs["energy"], frame_counts


def chroma_tonalness(chroma: jax.Array) -> jax.Array:
    """1 - normalized entropy of the chroma distribution (lib.rs:1236-1254)."""
    s = jnp.sum(chroma, axis=-1, keepdims=True)
    ok = s[..., 0] > EPSILON
    p = chroma / jnp.maximum(s, EPSILON)
    ent = -jnp.sum(jnp.where(p > EPSILON, p * jnp.log(jnp.maximum(p, EPSILON)), 0.0), axis=-1)
    t = 1.0 - ent / np.log(12.0)
    return jnp.where(ok, jnp.clip(t, 0.0, 1.0), 0.0)


def key_frame_weights(
    chroma: jax.Array, energy: jax.Array, fvalid: jax.Array, cfg: AnalysisConfig
):
    """Per-frame weights tonal^tp * (e/median)^ep (lib.rs:1256-1287) with the
    fallback-to-unweighted safety (sum ~ 0 or < 10 usable frames)."""
    if not cfg.enable_key_frame_weighting:
        return None
    med = masked.masked_median(energy, fvalid)
    med = jnp.maximum(med, EPSILON)
    tonal = chroma_tonalness(chroma)
    tonal = jnp.where(tonal < cfg.key_min_tonalness, 0.0, tonal)
    e_norm = jnp.maximum(energy / med[..., None], 0.0)
    w = jnp.power(tonal, max(cfg.key_tonalness_power, 0.0)) * jnp.power(
        e_norm, max(cfg.key_energy_power, 0.0)
    )
    w = jnp.where(fvalid, jnp.maximum(w, 0.0), 0.0)
    sum_w = jnp.sum(w, axis=-1, keepdims=True)
    used = jnp.sum(w > 0.0, axis=-1, keepdims=True)
    ok = (sum_w > EPSILON) & (used >= 10)
    return jnp.where(ok, w, jnp.where(fvalid, 1.0, 0.0))


@functools.partial(jax.jit, static_argnums=(2, 3), static_argnames=("mesh",))
def detect_key_batch(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    beat_times: jax.Array = None,
    beat_valid: jax.Array = None,
    mesh=None,
) -> KeyResult:
    """Full key path for a batch (lib.rs:961-1559): optional tuning / HPSS /
    beat-sync pre-passes, extract (+condition), sharpen, median-smooth,
    weight, then the configured detector."""
    tuning = 0.0
    if cfg.enable_key_tuning_compensation and not cfg.enable_key_log_frequency:
        tuning = estimate_tuning_streamed(samples, lengths, cfg, sample_rate, mesh=mesh)

    hpss_mask = None
    if cfg.enable_key_hpss_harmonic:
        hpss_mask = collect_hpss_mask(samples, lengths, cfg, sample_rate, mesh=mesh)

    use_beat_sync = (
        cfg.enable_key_beat_synchronous
        and not cfg.enable_key_log_frequency
        and beat_times is not None
    )
    if use_beat_sync:
        # per-frame plain chroma (extract_beat_synchronous_chroma uses
        # frame_to_chroma, not HPCP — extractor.rs:884-891)
        cfg_frames = cfg.replace(enable_key_hpcp=False)
        fchroma, fenergy, frame_counts = extract_key_features(
            samples, lengths, cfg_frames, sample_rate, tuning, hpss_mask, mesh=mesh
        )
        _, hop = _key_stft_params(cfg)
        frame_rate = sample_rate / hop
        fval = masked.length_mask(frame_counts, fchroma.shape[1])
        chroma, energy, interval_valid = chx.beat_synchronous_chroma(
            fchroma, fenergy, fval, beat_times, beat_valid, frame_rate
        )
        # interval slots become the "frames"; compact count = all intervals
        frame_counts = jnp.sum(interval_valid, axis=-1)
        # compact valid intervals to a prefix so downstream masks work
        order = jnp.argsort(~interval_valid, axis=-1, stable=True)
        chroma = jnp.take_along_axis(chroma, order[..., None], axis=1)
        energy = jnp.take_along_axis(energy, order, axis=1)
    else:
        chroma, energy, frame_counts = extract_key_features(
            samples, lengths, cfg, sample_rate, tuning, hpss_mask, mesh=mesh
        )
    f = chroma.shape[1]
    fvalid = masked.length_mask(frame_counts, f)

    if cfg.chroma_sharpening_power > 1.0:
        chroma = jnp.where(
            fvalid[..., None], sharpen_chroma(chroma, cfg.chroma_sharpening_power), 0.0
        )

    # temporal median smoothing, window 5, only when > 5 frames (lib.rs:1211-1213)
    smoothed = smooth_chroma_median(chroma, frame_counts, 5)
    chroma = jnp.where((frame_counts > 5)[:, None, None], smoothed, chroma)

    # edge trim (off by default): shift the valid window per track
    if cfg.enable_key_edge_trim:
        frac = float(np.clip(cfg.key_edge_trim_fraction, 0.0, 0.49))
        start = jnp.round(frame_counts.astype(jnp.float32) * frac).astype(jnp.int32)
        end = jnp.round(frame_counts.astype(jnp.float32) * (1.0 - frac)).astype(jnp.int32)
        do = (frame_counts >= 200) & (end > start + 50) & (end <= frame_counts)
        start = jnp.where(do, start, 0)
        new_counts = jnp.where(do, end - start, frame_counts)
        chroma = jax.vmap(
            lambda x, s: jax.lax.dynamic_slice(jnp.pad(x, ((0, f), (0, 0))), (s, 0), (f, 12))
        )(chroma, start)
        energy = jax.vmap(
            lambda x, s: jax.lax.dynamic_slice(jnp.pad(x, (0, f)), (s,), (f,))
        )(energy, start)
        frame_counts = new_counts
        fvalid = masked.length_mask(frame_counts, f)
        chroma = jnp.where(fvalid[..., None], chroma, 0.0)
        energy = jnp.where(fvalid, energy, 0.0)

    weights = key_frame_weights(chroma, energy, fvalid, cfg)

    if cfg.enable_key_ensemble:
        res = detector.detect_key_ensemble(chroma, weights, fvalid.astype(chroma.dtype), cfg)
    elif cfg.enable_key_multi_scale and cfg.key_multi_scale_lengths:
        res = detector.detect_key_multi_scale(
            chroma, weights, fvalid.astype(chroma.dtype), frame_counts, cfg
        )
    elif cfg.enable_key_segment_voting:
        res = detector.detect_key_segment_voting(
            chroma, weights, fvalid.astype(chroma.dtype), frame_counts, cfg
        )
    elif cfg.enable_key_median:
        res = detector.detect_key_median(
            chroma, weights, fvalid.astype(chroma.dtype), frame_counts, cfg
        )
    else:
        res = detector.detect_key_weighted(chroma, weights, fvalid.astype(chroma.dtype), cfg)

    # tracks too short for a single frame -> default key, zero confidence
    ok = frame_counts > 0
    return KeyResult(
        key_idx=jnp.where(ok, res.key_idx, 0),
        confidence=jnp.where(ok, res.confidence, 0.0),
        clarity=jnp.where(ok, res.clarity, 0.0),
        scores=jnp.where(ok[:, None], res.scores, 0.0),
    )
