"""Onset detection: energy flux, spectral flux, HFC, HPSS, consensus voting.

Design: onsets are fixed-capacity per-track tensors
``(positions [B, K] int32 samples, valid [B, K] bool)`` sorted by time, built
from dense peak masks over the frame grid. The reference's Vec-based detectors
live in ``src/features/onset/`` (energy_flux.rs, spectral_flux.rs, hfc.rs,
hpss.rs, consensus.rs, threshold.rs).
"""

from .peaks import peak_mask_1d, peaks_to_positions
from .energy_flux import detect_energy_flux_onsets
from .spectral import flux_onsets_from_curve
from .consensus import vote_onsets, consensus_onsets
from .hpss import hpss_decompose, percussive_energy_flux
from .threshold import adaptive_threshold_median_mad
