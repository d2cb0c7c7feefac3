"""Novelty-curve extraction (batched, streaming).

Batched mirror of the reference ``features/period/novelty.rs``:
SuperFlux (full-band + frequency sub-bands), energy flux, HFC, log-mel
SuperFlux, and the weighted/conditioned combination.

Architecture: instead of materializing spectrograms, a *reducer* plugged into
``ops.stft.stft_reduce`` emits tiny per-frame features while the STFT streams
in chunks:

* ``superflux``  [B, F, n_bands]  — max-filtered log-flux per band
  (novelty.rs:336-455; band max filter clamped inside the band)
* ``energy``     [B, F, n_bands]  — per-frame band energies (sum |X|^2)
* ``hfc``        [B, F, n_bands]  — per-frame band HFC (sum k*|X|^2, absolute k)
* ``mel``        [B, F, n_mels]   — HTK log-mel frames (novelty.rs:174-189)
* ``onset_sflux``[B, F]           — per-frame-max-normalized spectral flux
  used by the onset detector (onset/spectral_flux.rs:116-157)

Index convention: flux-type features at frame f describe the transition
(f-1 -> f); the reference's novelty curve value i corresponds to our frame
f = i+1, so curves are the emitted arrays shifted left by one with valid
count = frame_count - 1.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import AnalysisConfig
from ...ops import masked
from ...ops.stft import hz_to_bin, mel_filterbank_matrix, stft_reduce

EPSILON = 1e-10


def band_edges(cfg: AnalysisConfig, sample_rate: int, n_bins: int):
    """(start, end) bin ranges for full/low/mid/high bands
    (tempogram.rs:357-378). Returns a list of (name, start, end, weight)."""
    fft_size = (n_bins - 1) * 2
    fres = sample_rate / fft_size
    b0 = min(1, n_bins - 1)
    b_low = max(hz_to_bin(cfg.tempogram_band_low_max_hz, fres, n_bins), b0)
    b_mid = max(hz_to_bin(cfg.tempogram_band_mid_max_hz, fres, n_bins), b_low + 1)
    if cfg.tempogram_band_high_max_hz > 0.0:
        b_hi = max(hz_to_bin(cfg.tempogram_band_high_max_hz, fres, n_bins), b_mid + 1)
    else:
        b_hi = n_bins
    b_hi = min(b_hi, n_bins)
    return [
        ("full", 0, n_bins, cfg.tempogram_band_w_full),
        ("low", b0, b_low, cfg.tempogram_band_w_low),
        ("mid", b_low, b_mid, cfg.tempogram_band_w_mid),
        ("high", b_mid, b_hi, cfg.tempogram_band_w_high),
    ]


def _superflux_step(log_prev: jax.Array, log_cur: jax.Array, k: int, start: int, end: int):
    """SuperFlux value for one band over a chunk: sqrt(sum over band of
    max(0, cur - maxfilt(prev))^2), max filter clamped inside [start, end)
    (novelty.rs:359-375, 425-443)."""
    prev = log_prev[..., start:end]
    cur = log_cur[..., start:end]
    prev_max = masked.max_pool_1d(prev, max(k, 1))
    diff = jnp.maximum(cur - prev_max, 0.0)
    return jnp.sqrt(jnp.sum(diff * diff, axis=-1))


def make_bpm_reducer(
    cfg: AnalysisConfig,
    sample_rate: int,
    frame_size: int,
    emit_stride2=None,
    emit_onset_flux: bool = True,
):
    """Build the per-chunk reducer + carry init for the BPM spectral path.

    ``emit_stride2``/``emit_onset_flux`` let auxiliary passes (the multi-res
    hop-256 pass, the percussive rerun) skip outputs only the BASE hop pass
    consumes — superflux2 feeds the derived hop-1024 curves and onset_sflux
    feeds onset consensus; neither is read from a non-base pass, and XLA does
    not DCE unused scan outputs through the streaming reducer."""
    n_bins = frame_size // 2 + 1
    bands = band_edges(cfg, sample_rate, n_bins)
    use_bands = cfg.enable_tempogram_band_fusion
    sf_k = max(cfg.tempogram_superflux_max_filter_bins, 1)
    use_mel = cfg.enable_tempogram_mel_novelty
    mel_np = None
    if use_mel:
        mel_np = mel_filterbank_matrix(
            sample_rate,
            n_bins,
            cfg.tempogram_mel_n_mels,
            cfg.tempogram_mel_fmin_hz,
            cfg.tempogram_mel_fmax_hz,
        )
        mel_w = jnp.asarray(mel_np)

    active_bands = bands if use_bands else bands[:1]
    bin_weights = jnp.arange(n_bins, dtype=jnp.float32)
    if emit_stride2 is None:
        emit_stride2 = cfg.enable_tempogram_multi_resolution

    # Band energy/HFC as ONE [K, 2*n_bands] matmul over x^2 (differs from the
    # sliced jnp.sum only in reduction order). These skinny products are
    # memory-bound, so they run at HIGHEST: TF32 (the GPU's DEFAULT and HIGH)
    # would move onset decisions away from the CPU's.
    ew = np.zeros((n_bins, 2 * len(active_bands)), np.float32)
    for i, (_, s, e, _) in enumerate(active_bands):
        ew[s:e, 2 * i] = 1.0
        ew[s:e, 2 * i + 1] = np.arange(s, e, dtype=np.float32)
    n_act = len(active_bands)

    # SuperFlux band decomposition: the band-clamped max filter differs from
    # the full-band one only within sf_k bins of a band edge, so each band's
    # sum splits into an interior part read off ONE full-band d^2 pass (via a
    # [K, n_bands] mask matmul) plus exact little edge runs. This replaces
    # n_bands full-width maxpool+diff passes per stride with one.
    sf_mask = np.zeros((n_bins, n_act), np.float32)
    sf_mask[:, 0] = 1.0  # full band: the full-band pass is already exact
    edge_runs = []  # per band i>0: list of (lo, hi, t0, t1) slices
    for i, (_, s, e, _) in enumerate(active_bands):
        if i == 0:
            continue
        if e - s <= 2 * sf_k:
            edge_runs.append((i, [(s, e, 0, e - s)]))
        else:
            sf_mask[s + sf_k : e - sf_k, i] = 1.0
            edge_runs.append(
                (i, [
                    (s, s + 2 * sf_k, 0, sf_k),
                    (e - 2 * sf_k, e, sf_k, 2 * sf_k),
                ])
            )

    def _band_sf_sums(log_prev_x, log_cur, d2_interior):
        """[B, C, n_act] sums of clamped-filter d^2 per band."""
        sums = jnp.einsum(
            "bck,kj->bcj", d2_interior, jnp.asarray(sf_mask),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        cols = [sums[..., i] for i in range(n_act)]
        for i, runs in edge_runs:
            extra = 0.0
            for (lo, hi, t0, t1) in runs:
                pm = masked.max_pool_1d(log_prev_x[..., lo:hi], sf_k)
                d = jnp.maximum(log_cur[..., lo + t0 : lo + t1] - pm[..., t0:t1], 0.0)
                extra = extra + jnp.sum(d * d, axis=-1)
            cols[i] = cols[i] + extra
        return jnp.stack(cols, axis=-1)

    def reducer(spec, fidx, fvalid, carry):
        prev2_frames = carry  # [B, 2, K] previous two raw magnitude frames
        b, c, k = spec.shape
        ext = jnp.concatenate([prev2_frames, spec], axis=1)  # [B, C+2, K]
        # one log1p per frame; cur/prev/prev2 are shifted views of it.
        # spec may arrive bf16 (the bf16 fast path halves the materialized
        # magnitude stream); all derived math runs f32 from here on.
        log_ext = jnp.log1p(jnp.maximum(ext, 0.0).astype(jnp.float32))
        log_cur = log_ext[:, 2:]
        log_prev = log_ext[:, 1:-1]
        prev = ext[:, 1:-1]

        # The frequency max filter is independent of the frame axis, so ONE
        # maxpool over log_ext[:, :-1] serves both the stride-1 (prev =
        # log_ext[:, 1:-1]) and stride-2 (prev2 = log_ext[:, :-2]) SuperFlux
        # passes — halves the windowed-reduction work when emit_stride2.
        if emit_stride2:
            pm_ext = masked.max_pool_1d(log_ext[:, :-1], sf_k)
            pm_full = pm_ext[:, 1:]
        else:
            pm_full = masked.max_pool_1d(log_prev, sf_k)
        d_full = jnp.maximum(log_cur - pm_full, 0.0)
        sf = jnp.sqrt(_band_sf_sums(log_prev, log_cur, d_full * d_full))

        x2 = spec.astype(jnp.float32)
        x2 = x2 * x2
        eh = jnp.einsum(
            "bck,kj->bcj", x2, jnp.asarray(ew),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [B, C, 2*n_bands]: (energy, hfc) interleaved per band
        energy = eh[..., 0::2]
        hfc = eh[..., 1::2]

        outs = {"superflux": sf, "energy": energy, "hfc": hfc}

        if emit_stride2:
            # Stride-2 SuperFlux (frame f vs f-2): the hop-2H novelty of the
            # SAME signal — hop-2H STFT frames are exactly the even-index
            # hop-H frames, so the multi-res hop-1024 pass derives all its
            # curves from this pass's features with zero extra STFT work
            # (multi_resolution.rs:237-239 recomputes the STFT instead).
            log_prev2 = log_ext[:, :-2]
            pm2 = pm_ext[:, :-1]
            d2f = jnp.maximum(log_cur - pm2, 0.0)
            outs["superflux2"] = jnp.sqrt(_band_sf_sums(log_prev2, log_cur, d2f * d2f))

        if use_mel:
            outs["mel"] = jnp.dot(
                log_cur, mel_w, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )

        if emit_onset_flux:
            # Onset spectral flux: per-frame max-normalize then HWR L2 diff
            # (onset/spectral_flux.rs:116-157).
            ext_max = jnp.max(ext, axis=-1, keepdims=True)  # [B, C+2, 1]
            cur_max = ext_max[:, 2:]
            prev_max = ext_max[:, 1:-1]
            cur_n = jnp.where(
                cur_max > EPSILON,
                spec.astype(jnp.float32) / jnp.maximum(cur_max, EPSILON).astype(jnp.float32),
                0.0,
            )
            prev_n = jnp.where(
                prev_max > EPSILON,
                prev.astype(jnp.float32) / jnp.maximum(prev_max, EPSILON).astype(jnp.float32),
                0.0,
            )
            d = jnp.maximum(cur_n - prev_n, 0.0)
            outs["onset_sflux"] = jnp.sqrt(jnp.sum(d * d, axis=-1))

        new_carry = spec[:, -2:, :]
        return outs, new_carry

    def carry_init(b):
        # must match the streamed spec dtype: every stft_reduce path (fused
        # basis, polyphase, rfft fallback) emits f32 magnitudes — bf16 only
        # changes internal streams, never the spec handed to reducers.
        return jnp.zeros((b, 2, n_bins), jnp.float32)

    return reducer, carry_init, [name for (name, _, _, _) in active_bands]


def compute_bpm_spectral_features(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    frame_size: int,
    hop: int,
    chunk_frames: int = 512,
    emit_stride2=None,
    emit_onset_flux: bool = True,
):
    """Run the streaming STFT over the batch and return per-frame features.

    Returns (features dict, frame_counts [B], n_frames_padded).
    """
    # bound the [B, chunk, frame] buffer for large batches (see key pipeline)
    chunk_frames = int(min(chunk_frames, max(60_000_000 // max(samples.shape[0] * frame_size, 1), 128)))
    reducer, carry_init, band_names = make_bpm_reducer(
        cfg, sample_rate, frame_size,
        emit_stride2=emit_stride2, emit_onset_flux=emit_onset_flux,
    )
    outs, nf_padded, frame_counts = stft_reduce(
        samples, lengths, frame_size, hop, reducer, carry_init,
        chunk_frames=chunk_frames, bf16=cfg.stft_bf16,
    )
    outs["band_names"] = band_names
    return outs, frame_counts, nf_padded


def compute_bpm_features_from_spec(
    spec: jax.Array,
    frame_counts: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    frame_size: int,
    emit_stride2=None,
    emit_onset_flux: bool = True,
):
    """Same per-frame features as the streaming reducer, but from a
    materialized spectrogram ``[B, F, K]`` (used for HPSS / percussive
    variants where the spectrogram already exists). Invalid frames must be
    zeroed by the caller."""
    reducer, carry_init, band_names = make_bpm_reducer(
        cfg, sample_rate, frame_size,
        emit_stride2=emit_stride2, emit_onset_flux=emit_onset_flux,
    )
    b, f, k = spec.shape
    fvalid = masked.length_mask(frame_counts, f)
    spec = jnp.where(fvalid[..., None], spec, 0.0)
    fidx = jnp.arange(f)
    outs, _ = reducer(spec, fidx, fvalid, carry_init(b))
    outs["band_names"] = band_names
    return outs


def active_band_names(cfg: AnalysisConfig, sample_rate: int, frame_size: int):
    """Band-name list the reducer emits for this config (order matches the
    feature arrays' last axis)."""
    bands = band_edges(cfg, sample_rate, frame_size // 2 + 1)
    active = bands if cfg.enable_tempogram_band_fusion else bands[:1]
    return [name for (name, _, _, _) in active]


def decimate_features_2x(features: Dict[str, jax.Array], frame_counts: jax.Array):
    """Hop-2H per-frame features from hop-H streamed features.

    Hop-2H STFT frames are the even-index hop-H frames (same frame size), so:
    per-frame values (energy, hfc, mel) decimate by 2, and the flux-type
    feature comes from the stride-2 SuperFlux channel the reducer emits.
    Replaces the reference's full hop-1024 STFT recompute
    (multi_resolution.rs:237-239) with pure reindexing.

    Returns (features_2h, frame_counts_2h).
    """
    assert "superflux2" in features, "reducer must emit stride-2 superflux"
    out = {
        "superflux": features["superflux2"][:, ::2, :],
        "energy": features["energy"][:, ::2, :],
        "hfc": features["hfc"][:, ::2, :],
    }
    if "band_names" in features:
        out["band_names"] = features["band_names"]
    if "mel" in features:
        out["mel"] = features["mel"][:, ::2, :]
    fc2 = jnp.where(frame_counts > 0, (frame_counts - 1) // 2 + 1, 0)
    return out, fc2


def mel_superflux_from_frames(
    mel_frames: jax.Array, nov_mask: jax.Array, max_filter_mels: int
) -> jax.Array:
    """SuperFlux in mel space from per-frame log-mel vectors
    (novelty.rs:553-609). ``mel_frames`` is [B, F, M]; output novelty is
    [B, F-1] aligned so value i = transition (i -> i+1)."""
    k = max(max_filter_mels, 1)
    prev = mel_frames[:, :-1, :]
    cur = mel_frames[:, 1:, :]
    prev_max = masked.max_pool_1d(prev, k)
    d = jnp.maximum(cur - prev_max, 0.0)
    flux = jnp.sqrt(jnp.sum(d * d, axis=-1))
    flux = jnp.where(nov_mask, flux, 0.0)
    return masked.normalize_by_max(flux, nov_mask)


def flux_from_values(values: jax.Array, nov_mask: jax.Array) -> jax.Array:
    """HWR first difference, normalized: novelty[i] = max(0, v[i+1]-v[i])
    (novelty.rs:517-544 energy, 744-767 hfc)."""
    flux = jnp.maximum(values[:, 1:] - values[:, :-1], 0.0)
    flux = jnp.where(nov_mask, flux, 0.0)
    return masked.normalize_by_max(flux, nov_mask)


def combined_novelty_with_params(
    spectral: jax.Array,
    energy: jax.Array,
    hfc: jax.Array,
    nov_mask: jax.Array,
    w_spectral: float,
    w_energy: float,
    w_hfc: float,
    local_mean_window: int,
    smooth_window: int,
) -> jax.Array:
    """Weighted combination + conditioning (novelty.rs:874-932):
    normalize -> local-mean subtract + HWR -> moving-average smooth ->
    normalize."""
    ws = max(w_spectral, 0.0)
    we = max(w_energy, 0.0)
    wh = max(w_hfc, 0.0)
    wsum = max(ws + we + wh, EPSILON)
    combined = (spectral * ws + energy * we + hfc * wh) / wsum
    combined = jnp.where(nov_mask, combined, 0.0)
    combined = masked.normalize_by_max(combined, nov_mask)
    if local_mean_window > 1:
        combined = masked.local_mean_subtract(combined, nov_mask, local_mean_window)
    if smooth_window > 1:
        combined = masked.moving_average(combined, nov_mask, smooth_window)
    combined = jnp.where(nov_mask, combined, 0.0)
    return masked.normalize_by_max(combined, nov_mask)


def assemble_novelty_curves(
    features: Dict[str, jax.Array],
    frame_counts: jax.Array,
    cfg: AnalysisConfig,
) -> Tuple[Dict[str, jax.Array], jax.Array, jax.Array]:
    """Assemble the tempogram novelty variants from streamed features.

    Returns (curves dict name -> [B, N], nov_mask [B, N], n_valid [B]) where
    N = n_frames_padded - 1 and n_valid = frame_counts - 1.
    """
    band_names = features["band_names"]
    n_valid = jnp.maximum(frame_counts - 1, 0)
    nf = features["superflux"].shape[1]
    n = nf - 1
    nov_mask = masked.length_mask(n_valid, n)

    curves = {}
    for bi, name in enumerate(band_names):
        sf = features["superflux"][:, 1:, bi]
        sf = masked.normalize_by_max(jnp.where(nov_mask, sf, 0.0), nov_mask)
        en = flux_from_values(features["energy"][:, :, bi], nov_mask)
        hf = flux_from_values(features["hfc"][:, :, bi], nov_mask)
        curves[name] = combined_novelty_with_params(
            sf,
            en,
            hf,
            nov_mask,
            cfg.tempogram_novelty_w_spectral,
            cfg.tempogram_novelty_w_energy,
            cfg.tempogram_novelty_w_hfc,
            cfg.tempogram_novelty_local_mean_window,
            cfg.tempogram_novelty_smooth_window,
        )

    if cfg.enable_tempogram_mel_novelty and "mel" in features:
        curves["mel"] = mel_superflux_from_frames(
            features["mel"], nov_mask, cfg.tempogram_mel_max_filter_bins
        )

    return curves, nov_mask, n_valid
