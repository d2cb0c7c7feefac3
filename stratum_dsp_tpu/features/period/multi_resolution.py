"""Multi-resolution tempogram escalation (batched, branch-free).

Mirror of reference ``features/period/multi_resolution.rs:205-900``
(``multi_resolution_tempogram_from_samples``): recompute the spectral
features at hops {256, 512, 1024}, derive per-hop tempogram candidate lists,
fuse H(T)/H(2T)/H(T/2) hypothesis scores with structural discounts and
support-ratio guardrails, pick per-candidate winners with margin-gated
switching, dedup, then apply the post-hoc fold-down / fold-up and the
phase-optimized triplet-family search on the hop-512 novelty.

Batched design: the three hop passes run unconditionally for the whole batch
(the reference only escalates ambiguous tracks — on an accelerator the extra
FLOPs are cheaper than divergence; the orchestrator selects per track with a mask).
The phase search in ``beat_contrast_score`` evaluates ALL phases of ALL
family candidates as one gather tensor instead of the reference's nested
scalar loops.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from ...config import AnalysisConfig
from ...ops import masked
from . import novelty as nov
from . import tempogram as tg
from . import tempogram_fft as tft

EPSILON = 1e-6
HOPS = (256, 512, 1024)
DEDUP_TOL = 0.75
MAX_UNIQUE = 8
FAMILY_FACTORS = (1.0, 1.5, 2.0 / 3.0, 4.0 / 3.0, 0.75)
# The family search only evaluates candidates in [70, 180] BPM
# (multi_resolution.rs:773-780), i.e. hop-512 periods of 28.7..73.8 frames:
# cap phases at 80 and sample counts at n/PERIOD_MIN. These caps size the
# phase-search gather tensor, the dominant multi-res cost.
PHASE_CAP = 80
PERIOD_MIN = 24


def hop_candidates(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    hop: int,
    top_n: int,
    mesh=None,
):
    """One hop's tempogram candidate list + its full-band novelty curve."""
    if mesh is not None and "time" in mesh.shape:
        from ...parallel.timeblocks import compute_bpm_spectral_features_sharded

        feats, frame_counts, _ = compute_bpm_spectral_features_sharded(
            samples, lengths, cfg, sample_rate, cfg.frame_size, hop, mesh,
            emit_stride2=False, emit_onset_flux=False,
        )
    else:
        # Aux hop pass: superflux2 (hop-2H derivation) and onset_sflux are
        # consumed only from the BASE pass — skip their reducer work here.
        feats, frame_counts, _ = nov.compute_bpm_spectral_features(
            samples, lengths, cfg, sample_rate, cfg.frame_size, hop,
            chunk_frames=256, emit_stride2=False, emit_onset_flux=False,
        )
    curves, nov_mask, n_valid = nov.assemble_novelty_curves(feats, frame_counts, cfg)
    frame_rate = sample_rate / hop
    fft_size = tft.padded_fft_size(curves["full"].shape[-1], frame_rate)
    variants = tg.compute_variants(curves, nov_mask, n_valid, frame_rate, cfg, fft_size)
    est = tg.estimate_bpm_tempogram(variants, cfg, frame_rate, fft_size, top_n)
    return est, curves["full"], nov_mask, n_valid


def _lookup(cands: Dict[str, jax.Array], query: jax.Array, tol: float) -> jax.Array:
    return tg.cand_lookup_nearest(
        cands["cand_bpm"], cands["cand_score"], cands["cand_valid"], query, tol
    )


def beat_contrast_score(
    novelty: jax.Array, n_valid: jax.Array, bpm: jax.Array, sample_rate: int,
    hop: int, fractional: bool = False,
) -> jax.Array:
    """Phase-optimized beat-contrast alignment (multi_resolution.rs:580-678).

    ``novelty [B, N]``, ``bpm [B, F]`` family candidates. For each candidate:
    max over phases of (mean windowed-max at beats − 0.6·half − 0.4·thirds),
    normalized by the mean novelty. Returns [B, F].

    ``fractional`` (extension, config ``beat_contrast_fractional``, default
    False for parity): accumulate beat positions at FLOAT period and round
    each beat independently, instead of the reference's integer-frame comb
    (multi_resolution.rs:580-604). The integer comb's per-beat rounding
    drift loses fractional-BPM candidates — at 113.6 BPM the true period is
    45.48 frames but the comb steps 45, drifting one full frame every ~2
    beats, so the true tempo's contrast is destroyed and its 2/3-family
    member wins (frac_113.6 -> 75.7, reference-reproduced to 4 decimals).
    """
    b, n = novelty.shape
    f = bpm.shape[-1]
    frames_per_beat = (60.0 * sample_rate) / (jnp.maximum(bpm, EPSILON) * hop)
    period = jnp.round(frames_per_beat).astype(jnp.int32)  # [B, F]
    ok = (
        (n_valid[:, None] >= 16)
        & jnp.isfinite(frames_per_beat)
        & (frames_per_beat >= 3.0)
        & (period >= 3)
        & (period <= min(PHASE_CAP, 512))
    )
    ok = ok & (period >= PERIOD_MIN)  # family gates guarantee this; belt+braces
    p = jnp.clip(period, PERIOD_MIN, PHASE_CAP)  # [B, F]

    # windowed max +/-2 frames, masked outside valid range
    novm = jnp.where(masked.length_mask(n_valid, n), novelty, 0.0)
    mx = masked.max_pool_1d(novm, 2)  # [B, N]
    mx = jnp.where(masked.length_mask(n_valid, n), mx, 0.0)

    total = jnp.maximum(jnp.sum(novm, axis=-1), EPSILON)  # [B]
    mean_nov = jnp.maximum(total / jnp.maximum(n_valid, 1), EPSILON)  # [B]

    if fractional:
        # float-period comb: [B, F, P, K] rounded positions, gathered from
        # mx. Sizes are small because PERIOD_MIN bounds K at n/24 (~650 for
        # a 3-min track at hop 512) and phases at PHASE_CAP.
        fpb = jnp.clip(frames_per_beat, float(PERIOD_MIN), float(PHASE_CAP))
        n_k = int(n // PERIOD_MIN) + 2
        karr = jnp.arange(n_k, dtype=jnp.float32)
        jphase = (jnp.arange(PHASE_CAP, dtype=jnp.float32) / PHASE_CAP)
        base = jphase[None, None, :] * fpb[:, :, None]  # [B, F, P]

        def cmean(offset_frac, with_std=False):
            pos = base[..., None] + (karr + offset_frac)[None, None, None, :] \
                * fpb[:, :, None, None]
            q = jnp.round(pos).astype(jnp.int32)  # [B, F, P, K]
            valid = q < n_valid[:, None, None, None]
            qc = jnp.clip(q, 0, n - 1)
            v = jnp.take_along_axis(
                mx[:, None, :], qc.reshape(b, 1, -1), axis=-1
            ).reshape(b, f, PHASE_CAP, n_k)
            v = jnp.where(valid, v, 0.0)
            cnt = jnp.maximum(
                jnp.sum(valid, axis=-1).astype(jnp.float32), 1.0
            )  # [B, F, P]
            mean = jnp.sum(v, axis=-1) / cnt
            if not with_std:
                return mean, cnt
            var = jnp.sum(jnp.where(valid, (v - mean[..., None]) ** 2, 0.0),
                          axis=-1) / cnt
            return mean, cnt, jnp.sqrt(jnp.maximum(var, 0.0))

        beat_mean_f, beat_n_f, beat_std_f = cmean(0.0, with_std=True)
        half_mean_f, _ = cmean(0.5)
        t1f, t1nf = cmean(1.0 / 3.0)
        t2f, t2nf = cmean(2.0 / 3.0)
        third_f = (t1f * t1nf + t2f * t2nf) / jnp.maximum(t1nf + t2nf, 1.0)
        # Consistency penalty (fractional path only): a grid at a 2/3 or 4/3
        # relation of the true tempo alternates hit/miss beats — its beat
        # MEAN stays high while its half/third offsets land off every event,
        # escaping the reference's -0.6/-0.4 penalties. A true-tempo grid
        # hits EVERY beat (low per-beat std). Without this term the
        # drift-free comb systematically promotes 2/3-family members the
        # integer comb only rejected by accident of rounding drift.
        contrast = (beat_mean_f - 0.75 * beat_std_f) \
            - 0.60 * half_mean_f - 0.40 * third_f
        score = jnp.clip(contrast / mean_nov[:, None, None], -10.0, 10.0)
        best = jnp.max(jnp.where(beat_n_f > 0, score, -1e9), axis=-1)
        return jnp.where(ok, best, 0.0)

    # The sampled positions phase + k*period (+ period*num/den) tile the frame
    # axis: every frame i < n_valid belongs to exactly one (phase, k) pair via
    # phase = i mod p. So all four phase-grid means derive from ONE
    # modular-class sum T0[m] = sum of mx over frames i < n_valid with
    # i mod p == m — each offset variant is a cyclic reindex of T0 minus at
    # most one boundary term (the class member below the offset, whose base
    # would be negative). T0 itself is a chunked one-hot matmul, in place of
    # four [B, F, P, S] gathers of ~2.2M indices each.
    P = PHASE_CAP
    marr = jnp.arange(P)  # [P]
    CH = 2048
    nch = -(-n // CH)
    mxp = jnp.pad(mx, ((0, 0), (0, nch * CH - n)))
    ivalid = jnp.arange(nch * CH)[None, :] < n_valid[:, None]
    mxv = jnp.where(ivalid, mxp, 0.0)  # [B, nch*CH]
    t0 = jnp.zeros((b, f, P), jnp.float32)
    for c in range(nch):
        idx_c = jnp.asarray(np.arange(c * CH, (c + 1) * CH))  # [CH]
        lab = jnp.mod(idx_c[None, None, :], p[:, :, None])  # [B, F, CH]
        oh = (lab[..., None] == marr).astype(jnp.float32)  # [B, F, CH, P]
        t0 = t0 + jnp.einsum(
            "bc,bfcp->bfp", mxv[:, c * CH : (c + 1) * CH], oh,
            precision=jax.lax.Precision.HIGHEST,  # not TF32 on the GPU
        )
    # class counts in closed form: |{i < n_valid : i mod p == m}|
    nv = n_valid[:, None, None]
    pb = p[:, :, None]
    c0 = jnp.maximum((nv - marr[None, None, :] + pb - 1) // pb, 0)
    c0 = jnp.where(marr[None, None, :] < jnp.minimum(pb, nv), c0, 0)  # [B, F, P]

    mx_lo = jnp.where(jnp.arange(P)[None, :] < n_valid[:, None], mx[:, :P], 0.0)
    mx_lo_b = jnp.broadcast_to(mx_lo[:, None, :], (b, f, P))

    def class_mean(offset_num, offset_den):
        off = (p * offset_num) // offset_den  # [B, F], 0 <= off < p
        j0 = jnp.mod(marr[None, None, :] + off[:, :, None], pb)  # [B, F, P]
        t = jnp.take_along_axis(t0, j0, axis=-1)
        cc = jnp.take_along_axis(c0, j0, axis=-1)
        # drop the single class member below the offset (base would be < 0)
        drop = (j0 < off[:, :, None]) & (j0 < nv)
        t = t - jnp.where(drop, jnp.take_along_axis(mx_lo_b, j0, axis=-1), 0.0)
        cc = cc - drop
        return t / jnp.maximum(cc, 1), cc  # [B, F, P]

    beat_mean, beat_n = class_mean(0, 1)
    half_mean, half_n = class_mean(1, 2)
    third1, t1n = class_mean(1, 3)
    third2, t2n = class_mean(2, 3)
    third_mean = (third1 * t1n + third2 * t2n) / jnp.maximum(t1n + t2n, 1)

    half_mean = jnp.where(p[:, :, None] >= 6, half_mean, 0.0)
    third_mean = jnp.where(p[:, :, None] >= 9, third_mean, 0.0)

    contrast = beat_mean - 0.60 * half_mean - 0.40 * third_mean
    score = jnp.clip(contrast / mean_nov[:, None, None], -10.0, 10.0)
    phase_ok = (marr[None, None, :] < p[:, :, None]) & (beat_n > 0)
    best = jnp.max(jnp.where(phase_ok, score, -1e9), axis=-1)
    return jnp.where(ok, best, 0.0)


@functools.partial(jax.jit, static_argnums=(2, 3), static_argnames=("mesh",))
def multi_resolution_estimate(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    precomputed=None,
    mesh=None,
) -> Dict[str, jax.Array]:
    """Full multi-res pass. Returns dict bpm/confidence/method_agreement plus
    the hop-512 candidate arrays with 'selected' recomputed.

    ``precomputed`` (optional) carries the orchestrator's base hop-512
    artifacts so only the hop-256 STFT actually runs here:

    * ``est`` — the base tempogram estimate's dict (score-ordered candidate
      arrays, >= top_k wide). Identical to what a fresh hop-512 pass would
      produce because the base pass IS the hop-512 pass (cfg.hop_size == 512
      for every production config).
    * ``feats``/``frame_counts`` — the streamed per-frame features; the
      hop-1024 candidate list derives from them via
      ``novelty.decimate_features_2x`` (zero extra STFT work).
    * ``novelty_full``/``n_valid`` — hop-512 full-band novelty for the
      beat-contrast phase search.
    """
    top_k = max(cfg.tempogram_multi_res_top_k, 1)
    aux_k = int(np.clip(top_k * 4, 25, 200))
    tol = max(2.0, cfg.bpm_resolution)
    w512 = cfg.tempogram_multi_res_w512
    w256 = cfg.tempogram_multi_res_w256
    w1024 = cfg.tempogram_multi_res_w1024
    dt512 = cfg.tempogram_multi_res_double_time_512_factor
    margin_threshold = cfg.tempogram_multi_res_margin_threshold

    c256, _, _, _ = hop_candidates(
        samples, lengths, cfg, sample_rate, 256, aux_k, mesh=mesh
    )
    if precomputed is not None:
        c512 = {k: precomputed["est"][k][:, :top_k] for k in (
            "cand_bpm", "cand_score", "cand_fft", "cand_ac", "cand_valid", "cand_selected"
        )}
        nov512 = precomputed["novelty_full"]
        nval512 = precomputed["n_valid"]
        feats1024, fc1024 = nov.decimate_features_2x(
            precomputed["feats"], precomputed["frame_counts"]
        )
        feats1024["band_names"] = nov.active_band_names(
            cfg, sample_rate, cfg.frame_size
        )
        curves1024, mask1024, nval1024 = nov.assemble_novelty_curves(
            feats1024, fc1024, cfg
        )
        frame_rate_1024 = sample_rate / 1024
        fft_size_1024 = tft.padded_fft_size(
            curves1024["full"].shape[-1], frame_rate_1024
        )
        variants1024 = tg.compute_variants(
            curves1024, mask1024, nval1024, frame_rate_1024, cfg, fft_size_1024
        )
        c1024 = tg.estimate_bpm_tempogram(
            variants1024, cfg, frame_rate_1024, fft_size_1024, aux_k
        )
    else:
        c512, nov512, _nov_mask512, nval512 = hop_candidates(
            samples, lengths, cfg, sample_rate, 512, top_k, mesh=mesh
        )
        c1024, _, _, _ = hop_candidates(
            samples, lengths, cfg, sample_rate, 1024, aux_k, mesh=mesh
        )

    t_bpm = c512["cand_bpm"][:, :top_k]  # [B, K]
    t_valid = c512["cand_valid"][:, :top_k] & jnp.isfinite(t_bpm) & (t_bpm > 0.0)

    def sup(c, q):
        return _lookup(c, q, tol)

    s_t_512, s_t_256, s_t_1024 = sup(c512, t_bpm), sup(c256, t_bpm), sup(c1024, t_bpm)
    s2 = t_bpm * 2.0
    s_2t_512, s_2t_256, s_2t_1024 = sup(c512, s2), sup(c256, s2), sup(c1024, s2)
    sh = t_bpm * 0.5
    s_h_512, s_h_256, s_h_1024 = sup(c512, sh), sup(c256, sh), sup(c1024, sh)

    h_t = w512 * s_t_512 + w256 * s_t_256 + w1024 * s_t_1024
    h_2t = (
        w512 * (dt512 * s_t_512 + (1.0 - dt512) * s_2t_512)
        + w256 * s_2t_256
        + w1024 * s_2t_1024
    )
    h_half = (
        w512 * (dt512 * s_t_512 + (1.0 - dt512) * s_h_512)
        + w256 * s_h_256
        + w1024 * s_h_1024
    )
    # structural discounts (multi_resolution.rs:470-476)
    h_half = jnp.where(s_t_1024 > s_h_1024 * 1.02, h_half * 0.90, h_half)
    h_2t = jnp.where(s_t_1024 > s_2t_1024 * 1.02, h_2t * 0.90, h_2t)
    # support-ratio guardrails (multi_resolution.rs:479-494)
    r2t = (s_2t_256 + EPSILON) / (s_t_256 + EPSILON)
    h_2t = jnp.where(r2t < 1.10, h_2t * 0.75, h_2t)
    h_2t = jnp.where(r2t < 1.00, h_2t * 0.75, h_2t)
    rh = (s_h_1024 + EPSILON) / (s_t_1024 + EPSILON)
    h_half = jnp.where(rh < 1.10, h_half * 0.75, h_half)
    h_half = jnp.where(rh < 1.00, h_half * 0.75, h_half)

    def prior(bpm_arr, score):
        score = jnp.where(bpm_arr > 210.0, score * 0.80,
                          jnp.where(bpm_arr > 180.0, score * 0.90,
                                    jnp.where(bpm_arr < 60.0, score * 0.92, score)))
        return score

    hyp_bpm = jnp.stack([t_bpm, t_bpm * 2.0, t_bpm * 0.5], axis=-1)  # [B, K, 3]
    hyp_score = jnp.stack([h_t, h_2t, h_half], axis=-1)
    in_range = (hyp_bpm >= cfg.min_bpm) & (hyp_bpm <= cfg.max_bpm)
    hyp_score = prior(hyp_bpm, hyp_score)
    hyp_masked = jnp.where(in_range, hyp_score, -jnp.inf)

    order = jnp.argsort(-hyp_masked, axis=-1)
    best_h = order[..., 0]
    second_h = order[..., 1]
    tk = lambda a, i: jnp.take_along_axis(a, i[..., None], axis=-1)[..., 0]
    best_bpm_h = tk(hyp_bpm, best_h)
    best_score_h = tk(hyp_masked, best_h)
    second_score_h = jnp.maximum(tk(hyp_masked, second_h), 0.0)
    second_score_h = jnp.where(jnp.isfinite(second_score_h), second_score_h, 0.0)
    margin = best_score_h - second_score_h

    # margin-gated switch (multi_resolution.rs:503-508): keep T unless clear
    switch = (jnp.abs(best_bpm_h - t_bpm) > 1e-3) & (margin < margin_threshold)
    t_in_range = (t_bpm >= cfg.min_bpm) & (t_bpm <= cfg.max_bpm)
    chosen_bpm = jnp.where(switch & t_in_range, t_bpm, best_bpm_h)
    # the reference assigns the RAW h_t on fallback (rs:503-508 uses the
    # local variable, not the prior-scaled list entry) — for T outside
    # 60-180 that differs from prior(t, h_t); pinned by the numpy port
    chosen_score = jnp.where(switch & t_in_range, h_t, best_score_h)
    if cfg.tempogram_multi_res_use_human_prior:
        tie = (margin < margin_threshold) & (margin < 0.05) & (chosen_bpm >= 70.0) & (
            chosen_bpm <= 180.0
        )
        chosen_score = jnp.where(tie, chosen_score + 0.05, chosen_score)

    hyp_ok = t_valid & jnp.isfinite(chosen_score) & jnp.any(in_range, axis=-1)
    chosen_score = jnp.where(hyp_ok, chosen_score, -jnp.inf)

    # dedup by 0.75 BPM in score order, keep max-8 (multi_resolution.rs:530-546)
    sorder = jnp.argsort(-chosen_score, axis=-1)
    sb = jnp.take_along_axis(chosen_bpm, sorder, axis=-1)
    ss = jnp.take_along_axis(chosen_score, sorder, axis=-1)
    sv = jnp.take_along_axis(hyp_ok, sorder, axis=-1)

    def dstep(kept, i):
        near = jnp.any(jnp.abs(kept - sb[:, i][:, None]) < DEDUP_TOL, axis=-1)
        keep = sv[:, i] & ~near
        kept = kept.at[:, i].set(jnp.where(keep, sb[:, i], jnp.inf))
        return kept, keep

    kinit = jnp.full(sb.shape, jnp.inf)
    _, keeps = jax.lax.scan(dstep, kinit, jnp.arange(sb.shape[-1]), unroll=8)
    keep = jnp.moveaxis(keeps, 0, 1)
    rank = jnp.cumsum(keep, axis=-1)
    keep = keep & (rank <= MAX_UNIQUE)

    ub = jnp.where(keep, sb, 0.0)
    us = jnp.where(keep, ss, -jnp.inf)
    bidx = jnp.argmax(us, axis=-1)
    best_bpm = jnp.take_along_axis(ub, bidx[:, None], axis=-1)[:, 0]
    best_score = jnp.take_along_axis(us, bidx[:, None], axis=-1)[:, 0]
    # second-best among kept (for confidence)
    us2 = us.at[jnp.arange(us.shape[0]), bidx].set(-jnp.inf)
    second_best = jnp.maximum(jnp.max(us2, axis=-1), 0.0)
    second_best = jnp.where(jnp.isfinite(second_best), second_best, 0.0)

    def total_support(q):
        a = sup(c256, q)
        b_ = sup(c512, q)
        c = sup(c1024, q)
        return a + b_ + c, (a > 0).astype(jnp.int32) + (b_ > 0).astype(jnp.int32) + (
            c > 0
        ).astype(jnp.int32)

    # fold-down (multi_resolution.rs:697-724)
    half = best_bpm * 0.5
    s_best, _a_best = total_support(best_bpm)
    s_half, a_half = total_support(half)
    ratio_dn = jnp.where(s_best > 0.0, s_half / jnp.maximum(s_best, EPSILON), 0.0)
    do_dn = (
        (best_bpm >= 170.0)
        & (half >= 70.0)
        & (half <= 120.0)
        & (a_half >= 3)
        & (s_half > 0.0)
        & (s_best > 0.0)
        & (ratio_dn >= 0.45)
    )
    best_bpm = jnp.where(do_dn, half, best_bpm)
    best_score = jnp.where(do_dn, s_half, best_score)

    # fold-up (multi_resolution.rs:727-751)
    dbl = best_bpm * 2.0
    s_best2, _ = total_support(best_bpm)
    s_dbl, a_dbl = total_support(dbl)
    ratio_up = jnp.where(s_best2 > 0.0, s_dbl / jnp.maximum(s_best2, EPSILON), 0.0)
    do_up = (
        (best_bpm <= 80.0)
        & (dbl >= 70.0)
        & (dbl <= 180.0)
        & (a_dbl >= 2)
        & (s_dbl > 0.0)
        & (s_best2 > 0.0)
        & (ratio_up >= 0.55)
    )
    best_bpm = jnp.where(do_up, dbl, best_bpm)
    best_score = jnp.where(do_up, s_dbl, best_score)

    # triplet-family search (multi_resolution.rs:764-867)
    fam_bpm = best_bpm[:, None] * jnp.asarray(FAMILY_FACTORS)  # [B, 5]
    fam_in = (
        (fam_bpm >= cfg.min_bpm)
        & (fam_bpm <= cfg.max_bpm)
        & (fam_bpm >= 70.0)
        & (fam_bpm <= 180.0)
    )
    fs, fa = total_support(fam_bpm)
    fam_ok = fam_in & (fa >= 2) & (fs > 0.0)
    n_fam = jnp.sum(fam_ok, axis=-1)
    best_support = jnp.maximum(jnp.max(jnp.where(fam_ok, fs, 0.0), axis=-1), EPSILON)
    alt = fam_ok & (jnp.abs(fam_bpm - best_bpm[:, None]) > DEDUP_TOL)
    max_alt = jnp.max(jnp.where(alt, fs / best_support[:, None], 0.0), axis=-1)

    run_family = (best_bpm >= 70.0) & (best_bpm <= 180.0) & (n_fam >= 2) & (max_alt >= 0.45)
    align = beat_contrast_score(
        nov512, nval512, fam_bpm, sample_rate, 512,
        fractional=cfg.beat_contrast_fractional,
    )  # [B, 5]
    support_norm = jnp.clip(fs / best_support[:, None], 0.0, 1.0)
    fam_score = jnp.where(fam_ok, align + 0.35 * support_norm, -1e9)
    ch = jnp.argmax(fam_score, axis=-1)
    ch_bpm = jnp.take_along_axis(fam_bpm, ch[:, None], axis=-1)[:, 0]
    ch_align = jnp.take_along_axis(align, ch[:, None], axis=-1)[:, 0]
    ch_support = jnp.take_along_axis(fs, ch[:, None], axis=-1)[:, 0]
    cur_align = beat_contrast_score(
        nov512, nval512, best_bpm[:, None], sample_rate, 512,
        fractional=cfg.beat_contrast_fractional,
    )[:, 0]
    do_fam = (
        run_family
        & (jnp.abs(ch_bpm - best_bpm) > DEDUP_TOL)
        & (ch_align >= cur_align + 0.40)
    )
    best_bpm = jnp.where(do_fam, ch_bpm, best_bpm)
    best_score = jnp.where(do_fam, ch_support, best_score)

    confidence = jnp.where(
        best_score > EPSILON,
        jnp.clip(jnp.maximum(best_score - second_best, 0.0) / jnp.maximum(best_score, EPSILON), 0.0, 1.0),
        0.0,
    )
    _, agree = total_support(best_bpm)

    ok = jnp.any(hyp_ok, axis=-1)
    out = {
        "bpm": jnp.where(ok, best_bpm, 0.0),
        "confidence": jnp.where(ok, confidence, 0.0),
        "method_agreement": jnp.where(ok, agree, 0),
        "ok": ok,
        "cand_bpm": c512["cand_bpm"],
        "cand_score": c512["cand_score"],
        "cand_fft": c512["cand_fft"],
        "cand_ac": c512["cand_ac"],
        "cand_valid": c512["cand_valid"],
    }
    out["cand_selected"] = out["cand_valid"] & (
        jnp.abs(out["cand_bpm"] - out["bpm"][:, None]) < DEDUP_TOL
    )
    return out
