"""Batched analysis orchestrator.

Batched mirror of the reference's ``analyze_audio`` (``src/lib.rs:86-1634``)
over a padded ``[B, T]`` track batch: preprocessing -> onsets -> streamed
spectral features -> dual tempogram (+ masked multi-resolution escalation and
optional percussive fallback) -> legacy fallback/fusion -> beat grid -> key
-> warnings/flags/confidence.

The reference's data-dependent escalation becomes unconditional-but-masked
computation: every track pays for the multi-res pass (when the config enables
it) and a per-track select picks base vs escalated — on an accelerator the
extra FLOPs are cheaper than divergence (SURVEY §3.5).

Everything here is jittable with ``cfg`` (hashable dataclass) and ``caps``
static.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AnalysisConfig
from ..ops import masked
from ..ops.stft import stft_reduce
from ..preprocessing import normalization as norm
from ..preprocessing import silence as sil
from ..features.onset import (
    consensus_onsets,
    detect_energy_flux_onsets,
    flux_onsets_from_curve,
    hpss_decompose,
    percussive_energy_flux,
    vote_onsets,
)
from ..features.onset.spectral import hfc_flux
from ..features.period import legacy as legacy_mod
from ..features.period import multi_resolution as mr
from ..features.period import novelty as nov
from ..features.period import tempogram as tg
from ..features.period import tempogram_fft as tft
from ..features.beat import generate_beat_grid
from ..features.key import detect_key_batch
from . import confidence as conf_mod

EPSILON = 1e-6
FAMILY_RELS = (2.0, 1.5, 4.0 / 3.0)
PERC_FAMILY_RELS = (2.0, 1.5, 4.0 / 3.0, 1.5, 2.0 / 3.0, 0.75)  # rel is >= 1 by construction


@dataclasses.dataclass(frozen=True)
class PipelineCaps:
    """Static capacities (sized for a 3-minute track by default)."""

    max_onsets: int = 2048
    max_beats: int = 1024
    seg_beat_cap: int = 64
    max_segments: int = 48
    chunk_frames: int = 256


def _tempogram_estimate(curves, nov_mask, n_valid, cfg, frame_rate, top_n):
    fft_size = tft.padded_fft_size(curves["full"].shape[-1], frame_rate)
    variants = tg.compute_variants(curves, nov_mask, n_valid, frame_rate, cfg, fft_size)
    return tg.estimate_bpm_tempogram(variants, cfg, frame_rate, fft_size, top_n)


def _collect_spec(samples, lengths, frame_size, hop, chunk_frames, bf16=False):
    """Materialize the full magnitude spectrogram (only for the HPSS paths)."""

    def reducer(spec, fidx, fvalid, carry):
        return {"spec": spec}, carry

    outs, _, frame_counts = stft_reduce(
        samples, lengths, frame_size, hop, reducer, lambda b: jnp.zeros((b,)),
        chunk_frames=chunk_frames, bf16=bf16,
    )
    return outs["spec"], frame_counts


def analyze_batch_arrays(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    caps: PipelineCaps = PipelineCaps(),
    debug_stop_after: str = "",
    mesh=None,
) -> Dict[str, jax.Array]:
    """Run the full pipeline; returns a flat dict of result arrays [B, ...].

    Tracks that fail validation (empty / all silent after trimming) have
    ``ok`` False and zeroed outputs, mirroring the reference's error returns
    (lib.rs:100-110, 143-147).

    ``mesh`` (static): a ``jax.sharding.Mesh``. With a ``"time"`` axis, every
    sample-domain frontend (silence RMS, onset RMS, BPM/multi-res/key STFTs)
    runs time-block-sharded via ``parallel.timeblocks`` (overlap-save halos
    over ppermute, features all_gathered); everything downstream stays
    track-sharded. T must be divisible by n_time * 1024. HPSS paths
    (spectrogram materialization) are left to the SPMD partitioner.
    """
    b, t = samples.shape
    lengths = lengths.astype(jnp.int32)
    track_ok = lengths > 0

    # --- Phase 1A: preprocessing (lib.rs:112-147) ---
    if cfg.enable_normalization:
        # LUFS K-weighting stays f32 even when stft_bf16 is on: the filter
        # is a small share of the pipeline, so there is no reason to carry
        # the bf16 pass's ~0.02 dB LUFS drift vs the f32 reference path
        # (normalization.rs:185-259).
        samples, _norm_meta = norm.normalize(
            samples, lengths, cfg.normalization, sample_rate,
            target_loudness_lufs=-14.0, max_headroom_db=1.0,
            bf16=False,
        )
    trim_start = jnp.zeros((b,), jnp.int32)
    if cfg.enable_silence_trimming:
        samples, lengths, sil_info = sil.detect_and_trim(
            samples, lengths, sample_rate, cfg.min_amplitude_db,
            frame_size=cfg.frame_size, mesh=mesh,
        )
        track_ok = track_ok & ~sil_info["all_silent"]
        trim_start = sil_info["trim_start"]

    duration_s = lengths.astype(jnp.float32) / sample_rate

    # --- energy-flux onsets (lib.rs:152-159) ---
    e_pos, e_valid = detect_energy_flux_onsets(
        samples, lengths, cfg.frame_size, cfg.hop_size, -20.0, caps.max_onsets,
        mesh=mesh,
    )

    # --- shared streamed spectral features (lib.rs:164-166) ---
    if mesh is not None and "time" in mesh.shape:
        from ..parallel.timeblocks import compute_bpm_spectral_features_sharded

        feats, frame_counts, _ = compute_bpm_spectral_features_sharded(
            samples, lengths, cfg, sample_rate, cfg.frame_size, cfg.hop_size,
            mesh,
        )
    else:
        feats, frame_counts, _ = nov.compute_bpm_spectral_features(
            samples, lengths, cfg, sample_rate, cfg.frame_size, cfg.hop_size,
            chunk_frames=caps.chunk_frames,
        )
    curves, nov_mask, n_valid = nov.assemble_novelty_curves(feats, frame_counts, cfg)
    frame_rate = sample_rate / cfg.hop_size

    need_spec = cfg.enable_hpss_onsets or cfg.enable_tempogram_percussive_fallback
    if need_spec:
        full_spec, _ = _collect_spec(
            samples, lengths, cfg.frame_size, cfg.hop_size, caps.chunk_frames,
            bf16=cfg.stft_bf16,
        )
        _h, perc_spec = hpss_decompose(full_spec, frame_counts, cfg.hpss_margin)

    # --- onset consensus (lib.rs:176-291) ---
    onsets_pos, onsets_valid = e_pos, e_valid
    consensus_used = jnp.zeros((b,), bool)
    if cfg.enable_onset_consensus:
        sflux = feats["onset_sflux"][:, 1:]
        s_pos, s_valid = flux_onsets_from_curve(
            sflux, jnp.maximum(frame_counts - 1, 0), cfg.onset_threshold_percentile,
            cfg.hop_size, lengths, caps.max_onsets,
        )
        hflux, h_n = hfc_flux(feats["hfc"][:, :, 0], frame_counts)
        h_pos, h_valid = flux_onsets_from_curve(
            hflux, h_n, cfg.onset_threshold_percentile, cfg.hop_size, lengths,
            caps.max_onsets,
        )
        if cfg.enable_hpss_onsets:
            pflux, p_n = percussive_energy_flux(perc_spec, frame_counts)
            p_pos, p_valid = flux_onsets_from_curve(
                pflux, p_n, cfg.onset_threshold_percentile, cfg.hop_size, lengths,
                caps.max_onsets,
            )
        else:
            p_pos = jnp.zeros_like(e_pos)
            p_valid = jnp.zeros_like(e_valid)

        vote = vote_onsets(
            [e_pos, s_pos, h_pos, p_pos],
            [e_valid, s_valid, h_valid, p_valid],
            list(cfg.onset_consensus_weights),
            cfg.onset_consensus_tolerance_ms,
            sample_rate,
        )
        c_pos, c_valid = consensus_onsets(vote, caps.max_onsets)
        use_consensus = jnp.any(c_valid, axis=-1)
        onsets_pos = jnp.where(use_consensus[:, None], c_pos, e_pos)
        onsets_valid = jnp.where(use_consensus[:, None], c_valid, e_valid)
        consensus_used = use_consensus

    if debug_stop_after == "onsets":
        return {"pos": onsets_pos, "valid": onsets_valid}
    # --- legacy estimate (lib.rs:294-329) ---
    legacy = legacy_mod.estimate_bpm_legacy(onsets_pos, onsets_valid, t, sample_rate, cfg)

    if debug_stop_after == "legacy":
        return dict(legacy)
    # --- base tempogram (lib.rs:337-408) ---
    base_top_n = max(cfg.tempogram_candidates_top_n, cfg.tempogram_multi_res_top_k, 10)
    base = _tempogram_estimate(curves, nov_mask, n_valid, cfg, frame_rate, base_top_n)
    tempo_ok = frame_counts > 1  # needs novelty; mirrors spec-empty failure

    # --- ambiguity gate (lib.rs:412-459) ---
    tol = max(2.0, cfg.bpm_resolution)
    s_base = tg.cand_lookup_nearest(
        base["cand_bpm"], base["cand_score"], base["cand_valid"], base["bpm"], tol
    )
    s_2x = tg.cand_lookup_nearest(
        base["cand_bpm"], base["cand_score"], base["cand_valid"], base["bpm"] * 2.0, tol
    )
    s_half = tg.cand_lookup_nearest(
        base["cand_bpm"], base["cand_score"], base["cand_valid"], base["bpm"] * 0.5, tol
    )
    trap_low = (base["bpm"] >= 55.0) & (base["bpm"] <= 80.0)
    trap_high = (base["bpm"] >= 170.0) & (base["bpm"] <= 200.0)
    family_competes = ((s_2x > 0.0) & (s_2x >= s_base * 0.90)) | (
        (s_half > 0.0) & (s_half >= s_base * 0.90)
    )
    fold_into_trap = (base["bpm"] * 2.0 >= 170.0) & (base["bpm"] * 2.0 <= 200.0)
    weak_base = (base["method_agreement"] == 0) | (base["confidence"] < 0.06)
    ambiguous = trap_low | trap_high | family_competes | (weak_base & fold_into_trap)

    chosen_bpm = base["bpm"]
    chosen_conf = base["confidence"]
    chosen_agree = base["method_agreement"]
    cand_arrays = {k: base[k] for k in ("cand_bpm", "cand_score", "cand_fft", "cand_ac", "cand_valid", "cand_selected")}
    mr_triggered = ambiguous & tempo_ok
    mr_used = jnp.zeros_like(ambiguous)

    if cfg.enable_tempogram_multi_resolution:
        # The reference escalates only ambiguous tracks (lib.rs:493-579); the
        # 3-hop recompute sits behind a batch-level cond so unambiguous
        # batches skip its runtime entirely.
        top_k = max(cfg.tempogram_multi_res_top_k, 1)

        # The base pass already IS the hop-512 pass when cfg.hop_size == 512
        # (every production config): hand its candidates, novelty and streamed
        # features to multi-res so only the hop-256 STFT runs inside the cond
        # — the hop-1024 curves are derived by decimating the hop-512
        # features. Falls back to the 3-STFT recompute for exotic hop sizes.
        precomputed = None
        if cfg.hop_size == 512:
            precomputed = {
                "est": base,
                "feats": {
                    k: feats[k]
                    for k in ("superflux", "superflux2", "energy", "hfc", "mel")
                    if k in feats
                },
                "frame_counts": frame_counts,
                "novelty_full": curves["full"],
                "n_valid": n_valid,
            }

        esc = ambiguous & tempo_ok

        # Escalation sub-batching: multi-res is per-track independent, so
        # when only a few tracks are ambiguous, gather them into a fixed-
        # capacity sub-batch before paying the hop-256 STFT+novelty pass
        # (the dominant multi-res cost — it scales linearly in batch). Tiers
        # {B/8, B/4, 3B/8, B/2} keep shapes static; lax.switch picks the
        # smallest tier that fits (3B/8 added round 5: a 30% trap-zone mix
        # lands at ~12/40 escalated, just past B/4 — the extra tier keeps it
        # off the half-batch rung). The gathered pad rows (non-escalating tracks)
        # compute real results that downstream masking (mr_used requires
        # `ambiguous`) never uses.
        def tiered_escalation(samples_l, lengths_l, esc_l, pre_l):
            """Tiered multi-res over a (shard-)local [bl, T] batch.

            Runs identically on the whole batch (no mesh) and per-shard
            inside shard_map (1-D tracks mesh): the gather stays local to
            the shard, so no cross-device data movement and no collectives
            inside the lax.switch branches (each device may take a
            different tier — legal exactly because the branches are
            collective-free)."""
            bl = samples_l.shape[0]

            def skip(_):
                z = jnp.zeros((bl,), jnp.float32)
                zc = jnp.zeros((bl, top_k), jnp.float32)
                return {
                    "bpm": z, "confidence": z,
                    "method_agreement": jnp.zeros((bl,), jnp.int32),
                    "ok": jnp.zeros((bl,), bool),
                    "cand_bpm": zc, "cand_score": zc, "cand_fft": zc,
                    "cand_ac": zc,
                    "cand_valid": jnp.zeros((bl, top_k), bool),
                    "cand_selected": jnp.zeros((bl, top_k), bool),
                }

            def run_full(_):
                return mr.multi_resolution_estimate(
                    samples_l, lengths_l, cfg, sample_rate, pre_l, mesh=None
                )

            def run_sub(cap):
                def f(_):
                    order = jnp.argsort((~esc_l).astype(jnp.int32), stable=True)
                    idx = order[:cap]
                    take = lambda x: jnp.take(x, idx, axis=0)
                    sub_pre = (
                        jax.tree_util.tree_map(take, pre_l)
                        if pre_l is not None
                        else None
                    )
                    sub = mr.multi_resolution_estimate(
                        take(samples_l), take(lengths_l), cfg, sample_rate,
                        sub_pre, mesh=None,
                    )
                    full = skip(0)
                    return {k: full[k].at[idx].set(sub[k]) for k in full}

                return f

            caps_sub = [
                c
                for c in sorted({bl // 8, bl // 4, 3 * bl // 8, bl // 2})
                if 0 < c < bl
            ]
            branches = [skip] + [run_sub(c) for c in caps_sub] + [run_full]
            n_esc = jnp.sum(esc_l.astype(jnp.int32))
            tier = (n_esc > 0).astype(jnp.int32)
            for c in caps_sub:
                tier = tier + (n_esc > c).astype(jnp.int32)
            return jax.lax.switch(tier, branches, 0)

        if mesh is None:
            mres = tiered_escalation(samples, lengths, esc, precomputed)
        elif "time" not in mesh.shape:
            # Pod-safe sub-batching (round-4 verdict item 4): under the
            # production 1-D tracks mesh the tier logic runs PER SHARD via
            # shard_map — each device gathers its own ambiguous tracks into
            # a local sub-batch, preserving tracks-axis locality (no
            # cross-device gather, no full-batch multi-res tax on pods).
            from jax.sharding import PartitionSpec as P

            spec = P("tracks")
            if precomputed is None:
                mres = jax.shard_map(
                    lambda s, l, e: tiered_escalation(s, l, e, None),
                    mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                )(samples, lengths, esc)
            else:
                pre_spec = jax.tree_util.tree_map(lambda _: spec, precomputed)
                mres = jax.shard_map(
                    tiered_escalation, mesh=mesh,
                    in_specs=(spec, spec, spec, pre_spec), out_specs=spec,
                )(samples, lengths, esc, precomputed)
        else:
            # 2-D (tracks, time) mesh: the multi-res STFT itself is time-
            # sharded (halos over ppermute), which is incompatible with a
            # track gather; keep the batch-level cond with the full batch.
            def run_mr(_):
                return mr.multi_resolution_estimate(
                    samples, lengths, cfg, sample_rate, precomputed, mesh=mesh
                )

            def skip_mr(_):
                z = jnp.zeros((b,), jnp.float32)
                zc = jnp.zeros((b, top_k), jnp.float32)
                return {
                    "bpm": z, "confidence": z,
                    "method_agreement": jnp.zeros((b,), jnp.int32),
                    "ok": jnp.zeros((b,), bool),
                    "cand_bpm": zc, "cand_score": zc, "cand_fft": zc,
                    "cand_ac": zc,
                    "cand_valid": jnp.zeros((b, top_k), bool),
                    "cand_selected": jnp.zeros((b, top_k), bool),
                }

            mres = jax.lax.cond(jnp.any(esc), run_mr, skip_mr, 0)
        rel = jnp.where(
            chosen_bpm > EPSILON,
            jnp.maximum(mres["bpm"] / jnp.maximum(chosen_bpm, EPSILON),
                        chosen_bpm / jnp.maximum(mres["bpm"], EPSILON)),
            1.0,
        )
        family_related = jnp.zeros_like(rel, bool)
        for r in FAMILY_RELS:
            family_related = family_related | (jnp.abs(rel - r) < 0.05)
        forbid_high = (chosen_bpm <= 180.0) & (mres["bpm"] > 180.0)
        mr_better = ~forbid_high & (
            (mres["confidence"] >= chosen_conf + 0.05)
            | ((mres["method_agreement"] > chosen_agree) & (mres["confidence"] >= chosen_conf * 0.90))
            | (
                (trap_low | trap_high)
                & family_related
                & (mres["confidence"] >= chosen_conf * 0.88)
                & (((mres["bpm"] >= 70.0) & (mres["bpm"] <= 180.0)) | (chosen_bpm > 180.0))
            )
        )
        mr_used = ambiguous & mr_better & mres["ok"]
        chosen_bpm = jnp.where(mr_used, mres["bpm"], chosen_bpm)
        chosen_conf = jnp.where(mr_used, mres["confidence"], chosen_conf)
        chosen_agree = jnp.where(mr_used, mres["method_agreement"], chosen_agree)
        for k in cand_arrays:
            cand_arrays[k] = jnp.where(
                mr_used[:, None] if cand_arrays[k].ndim == 2 else mr_used,
                mres[k][:, : cand_arrays[k].shape[-1]],
                cand_arrays[k],
            )

    if debug_stop_after == "multires":
        return {"bpm": chosen_bpm, "conf": chosen_conf}
    # --- percussive fallback (lib.rs:587-683) ---
    perc_needed = ambiguous & trap_low
    perc_used = jnp.zeros_like(perc_needed)
    if cfg.enable_tempogram_percussive_fallback:
        pfeats = nov.compute_bpm_features_from_spec(
            perc_spec, frame_counts, cfg, sample_rate, cfg.frame_size,
            emit_stride2=False, emit_onset_flux=False,
        )
        pcurves, pmask, pn = nov.assemble_novelty_curves(pfeats, frame_counts, cfg)
        pest = _tempogram_estimate(pcurves, pmask, pn, cfg, frame_rate, base_top_n)
        rel = jnp.maximum(
            pest["bpm"] / jnp.maximum(chosen_bpm, EPSILON),
            chosen_bpm / jnp.maximum(pest["bpm"], EPSILON),
        )
        fam = jnp.zeros_like(rel, bool)
        for r in (2.0, 1.5, 4.0 / 3.0):
            fam = fam | (jnp.abs(rel - r) < 0.05)
        forbid_high = (chosen_bpm <= 180.0) & (pest["bpm"] > 180.0)
        base_low_trap = trap_low | (base["bpm"] < 95.0)
        in_common = (pest["bpm"] >= 70.0) & (pest["bpm"] <= 180.0)
        p_better = ~forbid_high & fam & in_common & (
            (pest["confidence"] >= chosen_conf + 0.04)
            | (base_low_trap & (pest["confidence"] >= chosen_conf * 0.85))
            | ((pest["method_agreement"] > chosen_agree) & (pest["confidence"] >= chosen_conf * 0.92))
        )
        perc_used = perc_needed & p_better
        chosen_bpm = jnp.where(perc_used, pest["bpm"], chosen_bpm)
        chosen_conf = jnp.where(perc_used, pest["confidence"], chosen_conf)
        chosen_agree = jnp.where(perc_used, pest["method_agreement"], chosen_agree)

    # --- BPM selection (lib.rs:814-900) ---
    tempo_valid = tempo_ok & (chosen_bpm > 0.0) & ~jnp.asarray(cfg.force_legacy_bpm)
    if cfg.force_legacy_bpm:
        bpm = jnp.where(legacy["ok"], legacy["bpm"], 0.0)
        bpm_confidence = jnp.where(legacy["ok"], legacy["confidence"], 0.0)
    elif cfg.enable_bpm_fusion:
        l_conf = jnp.clip(legacy["confidence"], 0.0, 1.0)
        t_conf = jnp.clip(chosen_conf, 0.0, 1.0)
        diffs = jnp.stack(
            [
                jnp.abs(legacy["bpm"] - chosen_bpm),
                jnp.abs(legacy["bpm"] - chosen_bpm * 0.5),
                jnp.abs(legacy["bpm"] - chosen_bpm * 2.0),
                jnp.abs(legacy["bpm"] - chosen_bpm * (2.0 / 3.0)),
                jnp.abs(legacy["bpm"] - chosen_bpm * 1.5),
            ],
            axis=-1,
        )
        agree = legacy["ok"] & (legacy["bpm"] > 0.0) & jnp.any(diffs <= 2.0, axis=-1)
        fused = jnp.where(
            agree,
            jnp.clip(t_conf + 0.12 * l_conf, 0.0, 1.0),
            jnp.where(legacy["ok"] & (legacy["bpm"] > 0.0), jnp.clip(t_conf * 0.90, 0.0, 1.0), t_conf),
        )
        bpm = jnp.where(tempo_valid, chosen_bpm, jnp.where(legacy["ok"], legacy["bpm"], 0.0))
        bpm_confidence = jnp.where(
            tempo_valid, fused, jnp.where(legacy["ok"], legacy["confidence"], 0.0)
        )
    else:
        bpm = jnp.where(tempo_valid, chosen_bpm, jnp.where(legacy["ok"], legacy["bpm"], 0.0))
        bpm_confidence = jnp.where(
            tempo_valid, chosen_conf, jnp.where(legacy["ok"], legacy["confidence"], 0.0)
        )

    bpm = jnp.where(track_ok, bpm, 0.0)
    bpm_confidence = jnp.where(track_ok, bpm_confidence, 0.0)
    # The final BPM came from the legacy autocorr+comb chain (forced, or the
    # tempogram fallback path lib.rs:894-899) rather than the tempogram.
    legacy_used = track_ok & (bpm > 0.0) & ~tempo_valid

    if debug_stop_after == "bpm_select":
        return {"bpm": bpm, "conf": bpm_confidence}
    # --- beat grid (lib.rs:913-958) ---
    onset_seconds = onsets_pos.astype(jnp.float32) / sample_rate
    anchor = None
    if cfg.enable_beat_phase_search:
        from ..features.beat.grid import search_phase_anchor

        # Phase salience curve: low band + half mid, NOT the full-band
        # SuperFlux. Broadband noise bursts (hi-hats) carry more full-band
        # flux than kicks (measured on the battery: full-band novelty is
        # 0.50 offbeat vs 0.38 on-beat on an offbeat-hat pattern, while the
        # low band is 0.002 vs 0.74) — metric salience lives in the low
        # (kick) and mid (snare) bands.
        if "low" in curves:
            phase_nov = curves["low"] + 0.5 * curves["mid"]
        else:
            phase_nov = curves["full"]
        anchor = search_phase_anchor(
            bpm, onset_seconds, onsets_valid & track_ok[:, None],
            phase_nov, n_valid, frame_rate, caps.max_beats,
        )
        # drift fit: refit (anchor, interval) against matched onsets so a
        # +-1 BPM quantization error does not shear the grid off the 70 ms
        # alignment window over the track (grid.fit_grid_drift guards)
        from ..features.beat.grid import fit_grid_drift

        anchor, iscale = fit_grid_drift(
            anchor, bpm, onset_seconds, onsets_valid & track_ok[:, None],
            caps.max_beats,
        )
    else:
        iscale = None
    grid = generate_beat_grid(
        bpm, bpm_confidence, onset_seconds, onsets_valid & track_ok[:, None],
        max_beats=caps.max_beats, seg_beat_cap=caps.seg_beat_cap,
        max_segments=caps.max_segments, anchor=anchor, interval_scale=iscale,
        fill=cfg.enable_beat_grid_fill,
    )
    if cfg.enable_downbeat_phase_search:
        from ..features.beat.grid import search_downbeat_phase

        if "low" in curves:
            db_nov = curves["low"] + 0.5 * curves["mid"]
        else:
            db_nov = curves["full"]
        grid = search_downbeat_phase(grid, db_nov, n_valid, frame_rate)

    if debug_stop_after == "grid":
        return {"bpm": bpm, "stability": grid.stability}
    # --- key (lib.rs:961-1559) ---
    if cfg.enable_key_beat_synchronous:
        key = detect_key_batch(
            samples, lengths, cfg, sample_rate, grid.beat_times, grid.beat_valid,
            mesh=mesh,
        )
    else:
        key = detect_key_batch(samples, lengths, cfg, sample_rate, mesh=mesh)
    key_ok = track_ok & (lengths >= cfg.frame_size)
    key_idx = jnp.where(key_ok, key.key_idx, 0)
    key_confidence = jnp.where(key_ok, key.confidence, 0.0)
    key_clarity = jnp.where(key_ok, key.clarity, 0.0)

    # --- warnings / flags / confidence (lib.rs:1564-1631) ---
    warn_bpm = bpm == 0.0
    warn_grid = grid.stability < 0.5
    warn_key_conf = key_confidence < 0.3
    warn_key_clarity = key_clarity < 0.2
    conf = conf_mod.compute_confidence(
        bpm, bpm_confidence, key_confidence, key_clarity, grid.stability,
        bpm_warning=warn_bpm,
        key_warning=warn_key_conf | warn_key_clarity,
    )

    out = {
        "ok": track_ok,
        "bpm": bpm,
        "bpm_confidence": bpm_confidence,
        "key_idx": key_idx,
        "key_confidence": key_confidence,
        "key_clarity": key_clarity,
        "beat_times": grid.beat_times,
        "beat_valid": grid.beat_valid,
        "downbeat_times": grid.downbeat_times,
        "downbeat_valid": grid.downbeat_valid,
        "grid_stability": jnp.where(track_ok, grid.stability, 0.0),
        "time_signature": grid.time_signature,
        "has_tempo_variation": grid.has_tempo_variation,
        "duration_seconds": duration_s,
        # Leading-trim offset: beat/downbeat times are in TRIMMED-track
        # coordinates (the reference analyzes trimmed samples, lib.rs:130-141
        # — its grid has the same convention); validation tooling adds this
        # back to score grids against original-coordinate ground truth.
        "trim_start_seconds": trim_start.astype(jnp.float32) / sample_rate,
        "onset_count": jnp.sum(onsets_valid, axis=-1),
        "onset_consensus_used": consensus_used,
        "legacy_used": legacy_used,
        "multi_res_triggered": mr_triggered,
        "multi_res_used": mr_used,
        "percussive_triggered": perc_needed & jnp.asarray(cfg.enable_tempogram_percussive_fallback),
        "percussive_used": perc_used,
        "warn_bpm_failed": warn_bpm,
        "warn_low_grid_stability": warn_grid,
        "warn_low_key_confidence": warn_key_conf,
        "warn_low_key_clarity": warn_key_clarity,
    }
    out.update({f"confidence_{k}": v for k, v in conf.items()})
    if cfg.emit_tempogram_candidates or cfg.debug_track_id is not None:
        k = min(cfg.tempogram_candidates_top_n, cand_arrays["cand_bpm"].shape[-1])
        for name, arr in cand_arrays.items():
            out[name] = arr[:, :k]
    if cfg.debug_track_id is not None:
        # Debug-diagnostics channel (lib.rs:461-487): the ambiguity-gate
        # signals plus the pre-escalation base estimate, host-formatted by
        # analysis.debug.format_debug_dump.
        out.update(
            dbg_base_bpm=base["bpm"],
            dbg_base_conf=base["confidence"],
            dbg_base_agree=base["method_agreement"],
            dbg_s_base=s_base,
            dbg_s_2x=s_2x,
            dbg_s_half=s_half,
            dbg_trap_low=trap_low,
            dbg_trap_high=trap_high,
            dbg_family_competes=family_competes,
            dbg_weak_base=weak_base,
            dbg_fold_into_trap=fold_into_trap,
            dbg_ambiguous=ambiguous,
        )
    return out


def analyze_batch(
    samples,
    lengths,
    cfg: AnalysisConfig = AnalysisConfig(),
    sample_rate: int = 44100,
    caps: PipelineCaps = PipelineCaps(),
    jit: bool = True,
):
    """User-facing entry: numpy/JAX arrays in, result-array dict out."""
    samples = jnp.asarray(samples, jnp.float32)
    lengths = jnp.asarray(lengths, jnp.int32)
    if jit:
        fn = jax.jit(
            analyze_batch_arrays, static_argnames=("cfg", "sample_rate", "caps")
        )
        return fn(samples, lengths, cfg=cfg, sample_rate=sample_rate, caps=caps)
    return analyze_batch_arrays(samples, lengths, cfg, sample_rate, caps)
