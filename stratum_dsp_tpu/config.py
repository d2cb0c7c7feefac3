"""Analysis configuration.

Mirror of the reference's ``AnalysisConfig`` (stratum-dsp
``src/config.rs:8-744``). The config is a *hashable frozen dataclass* so it can
be passed as a static argument to ``jax.jit``: every ``enable_*`` flag selects
code paths at **trace time**, which is the compiled-program replacement for the
reference's runtime branches — the compiled program contains exactly the
enabled pipeline, with no data-dependent control flow.

Field names, semantics, and defaults match ``src/config.rs:594-744`` so that
the validation harness and CLI flags map 1:1.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Optional, Tuple


class NormalizationMethod(enum.Enum):
    """Normalization method (reference ``preprocessing/normalization.rs:30-37``)."""

    PEAK = "peak"
    RMS = "rms"
    LOUDNESS = "loudness"  # ITU-R BS.1770-4 LUFS


class TemplateSet(enum.Enum):
    """Key template set (reference ``features/key/templates.rs:17-22``)."""

    KRUMHANSL_KESSLER = "krumhansl_kessler"
    TEMPERLEY = "temperley"


@dataclass(frozen=True)
class AnalysisConfig:
    """Tuned analysis configuration.

    Defaults mirror the reference's ``impl Default for AnalysisConfig``
    (``src/config.rs:594-744``) including the Phase-1F tuned values.
    """

    # --- Preprocessing (config.rs:10-21) ---
    min_amplitude_db: float = -40.0
    normalization: NormalizationMethod = NormalizationMethod.PEAK
    enable_normalization: bool = True
    enable_silence_trimming: bool = True

    # --- Onset detection (config.rs:23-43) ---
    enable_onset_consensus: bool = True
    onset_threshold_percentile: float = 0.80
    onset_consensus_tolerance_ms: int = 50
    onset_consensus_weights: Tuple[float, float, float, float] = (0.25, 0.25, 0.25, 0.25)
    enable_hpss_onsets: bool = False
    hpss_margin: int = 10

    # --- BPM detection (config.rs:45-229) ---
    force_legacy_bpm: bool = False
    enable_bpm_fusion: bool = False
    enable_legacy_bpm_guardrails: bool = True
    enable_tempogram_multi_resolution: bool = True
    tempogram_multi_res_top_k: int = 25
    tempogram_multi_res_w512: float = 0.45
    tempogram_multi_res_w256: float = 0.35
    tempogram_multi_res_w1024: float = 0.20
    tempogram_multi_res_structural_discount: float = 0.85
    tempogram_multi_res_double_time_512_factor: float = 0.92
    tempogram_multi_res_margin_threshold: float = 0.08
    tempogram_multi_res_use_human_prior: bool = False
    enable_tempogram_percussive_fallback: bool = False
    enable_tempogram_band_fusion: bool = True
    tempogram_band_low_max_hz: float = 200.0
    tempogram_band_mid_max_hz: float = 2000.0
    tempogram_band_high_max_hz: float = 8000.0
    tempogram_band_w_full: float = 0.40
    tempogram_band_w_low: float = 0.25
    tempogram_band_w_mid: float = 0.20
    tempogram_band_w_high: float = 0.15
    tempogram_band_seed_only: bool = True
    tempogram_band_support_threshold: float = 0.25
    tempogram_band_consensus_bonus: float = 0.08
    tempogram_novelty_w_spectral: float = 0.30
    tempogram_novelty_w_energy: float = 0.35
    tempogram_novelty_w_hfc: float = 0.35
    tempogram_novelty_local_mean_window: int = 16
    tempogram_novelty_smooth_window: int = 5
    debug_track_id: Optional[int] = None
    debug_gt_bpm: Optional[float] = None
    debug_top_n: int = 5
    enable_tempogram_mel_novelty: bool = True
    tempogram_mel_n_mels: int = 40
    tempogram_mel_fmin_hz: float = 30.0
    tempogram_mel_fmax_hz: float = 8000.0
    tempogram_mel_max_filter_bins: int = 2
    tempogram_mel_weight: float = 0.15
    tempogram_superflux_max_filter_bins: int = 4
    emit_tempogram_candidates: bool = False
    tempogram_candidates_top_n: int = 10
    legacy_bpm_preferred_min: float = 72.0
    legacy_bpm_preferred_max: float = 168.0
    legacy_bpm_soft_min: float = 60.0
    legacy_bpm_soft_max: float = 210.0
    legacy_bpm_conf_mul_preferred: float = 1.30
    legacy_bpm_conf_mul_soft: float = 0.70
    legacy_bpm_conf_mul_extreme: float = 0.01
    min_bpm: float = 40.0
    max_bpm: float = 240.0
    bpm_resolution: float = 1.0

    # --- STFT (config.rs:231-236) ---
    frame_size: int = 2048
    hop_size: int = 512
    # Extension (no reference counterpart). Selects the key STFT's
    # formulation only; every other STFT is the f32 rfft either way. True:
    # the key STFT (8192/512) takes the polyphase shared-block path
    # (ops/stft.py) with bf16 stage inputs + f32 accumulation and a periodic
    # Hann window; the ~2^-9 relative rounding is far below the decision
    # margins of every downstream discrete estimate (BPM family, key, beat
    # phase) — asserted end-to-end by
    # tests/test_stft.py::test_bf16_pipeline_parity. False: the key STFT is
    # the f32 symmetric-Hann rfft like the rest.
    stft_bf16: bool = True
    # Extension (no reference counterpart), default ON: replace the beat
    # grid's first-detected-onset phase anchor (hmm.rs:241-249) with a
    # low-band-novelty phase search over one beat interval
    # (features/beat/grid.py:search_phase_anchor). The reference convention
    # phase-locks the whole grid to the offbeat whenever the first detected
    # onset is not on-beat (e.g. the track-opening kick has no preceding
    # baseline frame for the flux derivative and an offbeat hat is detected
    # first) — measured at battery scale: mean beat F-measure 0.21 with the
    # reference anchor vs ~0.9 with the search, identical BPM/key outputs.
    # Set False for the reference-faithful anchor (the battery's secondary
    # reference-anchor pass pins that baseline).
    enable_beat_phase_search: bool = True
    # Extension (default ON; False = reference convention): emit EVERY grid
    # slot between the first and last supported beats instead of only slots
    # with emission > 0.1 (hmm.rs:393-396). A backbeat track whose detected
    # onsets are kicks-only otherwise gets a half-density grid (beats 2/4
    # dropped), capping beat F-measure at ~0.5 with a correct tempo+phase.
    # Unsupported slots keep their (low) emission-based confidence.
    enable_beat_grid_fill: bool = True
    # Extension (default ON; False = reference convention): choose the bar
    # phase (which beat is the downbeat) by scoring the beats_per_bar
    # candidate rotations against low-band novelty at the marked beats,
    # instead of unconditionally calling the FIRST tracked beat a downbeat
    # (mod.rs:363-404). The reference has no accent model, so its bar phase
    # is arbitrary whenever the track does not start exactly on a downbeat.
    enable_downbeat_phase_search: bool = True
    # Extension (default OFF for parity): accumulate the multi-res triplet
    # beat-contrast grid at FLOAT period resolution instead of the
    # reference's integer-frame comb (multi_resolution.rs:580-604), whose
    # per-beat rounding drift loses fractional-BPM families (frac_113.6 ->
    # 75.7 is reference-reproduced to 4 decimals).
    beat_contrast_fractional: bool = False

    # --- Key detection (config.rs:238-587) ---
    center_frequency: float = 440.0
    soft_chroma_mapping: bool = True
    soft_mapping_sigma: float = 0.5
    chroma_sharpening_power: float = 1.0
    enable_key_spectrogram_time_smoothing: bool = True
    key_spectrogram_smooth_margin: int = 12
    enable_key_frame_weighting: bool = True
    key_min_tonalness: float = 0.0
    key_tonalness_power: float = 2.0
    key_energy_power: float = 0.50
    enable_key_harmonic_mask: bool = True
    key_harmonic_mask_power: float = 2.0
    enable_key_hpss_harmonic: bool = False
    key_hpss_frame_step: int = 4
    key_hpss_time_margin: int = 8
    key_hpss_freq_margin: int = 8
    key_hpss_mask_power: float = 2.0
    enable_key_stft_override: bool = True
    key_stft_frame_size: int = 8192
    key_stft_hop_size: int = 512
    enable_key_log_frequency: bool = False
    enable_key_beat_synchronous: bool = False
    enable_key_multi_scale: bool = False
    key_multi_scale_lengths: Tuple[int, ...] = (120, 360, 720)
    key_multi_scale_hop: int = 60
    key_multi_scale_min_clarity: float = 0.20
    key_multi_scale_weights: Tuple[float, ...] = ()
    key_template_set: TemplateSet = TemplateSet.KRUMHANSL_KESSLER
    enable_key_ensemble: bool = False
    key_ensemble_kk_weight: float = 0.5
    key_ensemble_temperley_weight: float = 0.5
    enable_key_median: bool = False
    key_median_segment_length_frames: int = 480
    key_median_segment_hop_frames: int = 120
    key_median_min_segments: int = 3
    enable_key_tuning_compensation: bool = False
    key_tuning_max_abs_semitones: float = 0.08
    key_tuning_frame_step: int = 20
    key_tuning_peak_rel_threshold: float = 0.35
    enable_key_edge_trim: bool = False
    key_edge_trim_fraction: float = 0.15
    enable_key_segment_voting: bool = True
    key_segment_len_frames: int = 1024
    key_segment_hop_frames: int = 512
    key_segment_min_clarity: float = 0.20
    enable_key_mode_heuristic: bool = False
    key_mode_third_ratio_margin: float = 0.00
    key_mode_flip_min_score_ratio: float = 0.60
    enable_key_hpcp: bool = True
    key_hpcp_peaks_per_frame: int = 24
    # Extension (no reference analogue): select the top-K spectral peaks
    # with a threshold search (O(n), recall ~0.95+) instead of an exact sort
    # (O(n log^2 n) bitonic — the hottest op of the key path). Harmonic
    # summation is order-independent, so only rare
    # borderline-peak set differences can change the HPCP. False = exact.
    key_hpcp_approx_peaks: bool = True
    key_hpcp_num_harmonics: int = 4
    key_hpcp_harmonic_decay: float = 0.60
    key_hpcp_mag_power: float = 0.50
    enable_key_hpcp_whitening: bool = False
    key_hpcp_whitening_smooth_bins: int = 31
    enable_key_hpcp_bass_blend: bool = False
    key_hpcp_bass_fmin_hz: float = 55.0
    key_hpcp_bass_fmax_hz: float = 300.0
    key_hpcp_bass_weight: float = 0.35
    enable_key_minor_harmonic_bonus: bool = False
    key_minor_leading_tone_bonus_weight: float = 0.2

    def replace(self, **kwargs) -> "AnalysisConfig":
        """Return a copy with the given fields replaced."""
        return dataclasses.replace(self, **kwargs)

    def __post_init__(self):
        # Tuples keep the dataclass hashable for jit static args.
        if isinstance(self.onset_consensus_weights, list):
            object.__setattr__(
                self, "onset_consensus_weights", tuple(self.onset_consensus_weights)
            )
        if isinstance(self.key_multi_scale_lengths, list):
            object.__setattr__(
                self, "key_multi_scale_lengths", tuple(self.key_multi_scale_lengths)
            )
        if isinstance(self.key_multi_scale_weights, list):
            object.__setattr__(
                self, "key_multi_scale_weights", tuple(self.key_multi_scale_weights)
            )


DEFAULT_CONFIG = AnalysisConfig()
