"""Legacy onset-based BPM path: FFT autocorrelation + comb filterbank +
candidate merge with guardrails.

Mirror of reference ``features/period/{mod,autocorrelation,comb_filter,
candidate_filter}.rs``. Everything operates on the fixed-capacity onset
tensors ``(positions [B, K] int32 samples, valid [B, K])``.

The merge stage's greedy running-mean grouping (candidate_filter.rs:276-346)
is a short ``lax.scan`` over ~34 candidate slots — tiny, batched over B. The
reference's final comparator ("prefer 60-180 when effective confidences are
within 0.5") reduces to sorting by ``effective_conf + 0.5 * in_range`` with
effective_conf = conf * (1 if in-range else 0.5), which reproduces the
pairwise decisions exactly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import AnalysisConfig
from .tempogram_fft import next_pow2

EPSILON = 1e-10
BIG = 1e9
MAX_PER_METHOD = 10
AC_CAP = 24  # top 10 + re-added reasonable-range autocorr candidates
REASONABLE_MIN, REASONABLE_MAX = 60.0, 180.0

# comb tolerance constants (comb_filter.rs:40-45)
COMB_DEFAULT_TOLERANCE = 0.10
COMB_REFERENCE_BPM = 120.0
COMB_MIN_TOLERANCE = 0.05
COMB_MAX_TOLERANCE = 0.15


class CandidateList(NamedTuple):
    bpm: jax.Array  # [B, C]
    confidence: jax.Array  # [B, C]
    valid: jax.Array  # [B, C]


@functools.lru_cache(maxsize=32)
def comb_bpm_grid(min_bpm: float, max_bpm: float, resolution: float) -> np.ndarray:
    """f32-accumulated grid, loop `while bpm <= max + EPS` (comb_filter.rs:157)."""
    grid = []
    bpm = np.float32(min_bpm)
    while bpm <= np.float32(max_bpm) + np.float32(EPSILON):
        grid.append(float(bpm))
        bpm = np.float32(bpm + np.float32(resolution))
    return np.asarray(grid, dtype=np.float32)


def _nearest_onset_distance_sorted(query: jax.Array, onsets: jax.Array, n_valid: jax.Array):
    """|query - nearest onset| for sorted ``onsets [B, K]`` (invalid = BIG)."""
    k = onsets.shape[-1]

    def per_row(q, o, nv):
        qf = q.reshape(-1)
        idx = jnp.searchsorted(o, qf)
        lo = jnp.clip(idx - 1, 0, k - 1)
        hi = jnp.clip(idx, 0, k - 1)
        d_lo = jnp.where(idx > 0, jnp.abs(qf - o[lo]), BIG)
        d_hi = jnp.where(idx < nv, jnp.abs(qf - o[hi]), BIG)
        return jnp.minimum(d_lo, d_hi).reshape(q.shape)

    return jax.vmap(per_row)(query, onsets, n_valid)


def autocorr_candidates(
    onset_pos: jax.Array,
    onset_valid: jax.Array,
    t_padded: int,
    sample_rate: int,
    hop: int,
    min_bpm: float,
    max_bpm: float,
) -> CandidateList:
    """FFT-ACF candidates (autocorrelation.rs:99-268): onsets -> binary frame
    signal, ACF = irfft(|rfft|^2), local maxima with prominence >= 10% of the
    in-range max, confidence = value / max(ACF)."""
    b, k = onset_pos.shape
    nf = t_padded // hop + 1
    frames = jnp.clip(onset_pos // hop, 0, nf - 1)
    signal = jax.vmap(
        lambda f, v: jnp.zeros((nf,), jnp.float32).at[f].max(v.astype(jnp.float32))
    )(frames, onset_valid)

    fft_size = next_pow2(2 * nf)
    spec = jnp.fft.rfft(signal, n=fft_size, axis=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    acf = jnp.maximum(jnp.fft.irfft(power, n=fft_size, axis=-1)[:, :nf], 0.0)

    lag_min = int(np.ceil(60.0 * sample_rate / (max_bpm * hop)))
    lag_max = int(np.floor(60.0 * sample_rate / (min_bpm * hop)))
    lag_max = min(lag_max, nf - 1)
    if lag_min >= lag_max:
        z = jnp.zeros((b, 1), jnp.float32)
        return CandidateList(z, z, jnp.zeros((b, 1), bool))

    sl = acf[:, lag_min : lag_max + 1]
    n_sl = sl.shape[1]
    max_sl = jnp.max(sl, axis=-1, keepdims=True)
    prev = jnp.concatenate([sl[:, :1], sl[:, :-1]], axis=-1)
    nxt = jnp.concatenate([sl[:, 1:], sl[:, -1:]], axis=-1)
    interior = (np.arange(n_sl) >= 1) & (np.arange(n_sl) < n_sl - 1)
    prominence = sl - jnp.maximum(prev, nxt)
    is_peak = (
        jnp.asarray(interior)
        & (sl > prev)
        & (sl > nxt)
        & (prominence >= 0.1 * max_sl)
        & (max_sl >= EPSILON)
    )

    lags_np = np.arange(lag_min, lag_max + 1, dtype=np.float32)
    bpm_np = (60.0 * sample_rate) / (lags_np * hop)
    bpm = jnp.asarray(bpm_np)
    is_peak = is_peak & jnp.asarray((bpm_np >= min_bpm) & (bpm_np <= max_bpm))

    acf_max = jnp.maximum(jnp.max(acf, axis=-1, keepdims=True), EPSILON)
    conf = jnp.minimum(sl / acf_max, 1.0)

    # tracks with < 2 onsets produce no candidates (autocorrelation.rs:144-147)
    enough = jnp.sum(onset_valid, axis=-1) >= 2
    is_peak = is_peak & enough[:, None]

    # sort by confidence desc, keep AC capacity = full slice (small)
    key = jnp.where(is_peak, -conf, jnp.inf)
    order = jnp.argsort(key, axis=-1)
    return CandidateList(
        bpm=jnp.take_along_axis(jnp.broadcast_to(bpm, sl.shape), order, axis=-1),
        confidence=jnp.take_along_axis(conf, order, axis=-1),
        valid=jnp.take_along_axis(is_peak, order, axis=-1),
    )


def comb_candidates(
    onset_pos: jax.Array,
    onset_valid: jax.Array,
    t_padded: int,
    sample_rate: int,
    min_bpm: float,
    max_bpm: float,
    resolution: float,
) -> CandidateList:
    """Comb-filterbank grid scoring (comb_filter.rs:96-400): per candidate
    BPM, the fraction of expected beats (anchored at sample 0) with an onset
    within the adaptive tolerance; normalized by the grid max; entries with
    confidence < 0.1 dropped."""
    b, k = onset_pos.shape
    grid = comb_bpm_grid(min_bpm, max_bpm, resolution)
    n_bpm = len(grid)
    period = 60.0 * sample_rate / grid  # [n_bpm]
    tol = np.clip(
        COMB_DEFAULT_TOLERANCE * (COMB_REFERENCE_BPM / grid),
        COMB_MIN_TOLERANCE,
        COMB_MAX_TOLERANCE,
    ) * period

    # Onset-centric alignment count (beat-centric in the reference,
    # comb_filter.rs:355-380): a beat k is "aligned" iff its nearest onset is
    # within tol. Because tol <= 0.15*period < period/2, an onset within tol
    # of beat k necessarily has k as its *nearest* beat (round(o/period)), so
    # counting DISTINCT claimed beats among onsets with |o - k*period| <= tol
    # is exactly the reference count — with zero sequential searchsorted
    # loops. Distinctness uses the fact that k is nondecreasing over the
    # sorted onset list: an onset is a duplicate iff the previous *hit* onset
    # claimed the same k (prefix cummax of hit indices + gather).
    sorted_pos = jnp.sort(
        jnp.where(onset_valid, onset_pos, jnp.iinfo(jnp.int32).max), axis=-1
    ).astype(jnp.float32)
    n_valid = jnp.sum(onset_valid, axis=-1)
    last = jnp.max(jnp.where(onset_valid, onset_pos, 0), axis=-1).astype(jnp.float32)

    ovalid = jnp.arange(k)[None, :] < n_valid[:, None]  # [B, K]
    period_j = jnp.asarray(period)[None, :, None]  # [1, n_bpm, 1]
    o = sorted_pos[:, None, :]  # [B, 1, K]
    k_idx = jnp.round(o / period_j).astype(jnp.int32)  # [B, n_bpm, K]
    d = jnp.abs(o - k_idx.astype(jnp.float32) * period_j)
    hit = (d <= jnp.asarray(tol)[None, :, None]) & ovalid[:, None, :]

    # k_idx is nondecreasing over the sorted onsets, so the k claimed by the
    # last hit before j is simply the running max of (hit ? k : -1) — a
    # cummax instead of a [B, n_bpm, K] gather.
    k_hit = jnp.where(hit, k_idx, -1)
    k_prev = jnp.concatenate(
        [jnp.full_like(k_hit[..., :1], -1), jax.lax.cummax(k_hit, axis=2)[..., :-1]],
        axis=-1,
    )  # k claimed by the last hit strictly before j (-1 if none)
    dup = hit & (k_prev == k_idx)
    aligned = jnp.sum(hit & ~dup, axis=-1)  # [B, n_bpm] distinct aligned beats

    n_beats = jnp.ceil(last[:, None] / jnp.asarray(period)[None, :]) + 1  # [B, n_bpm]
    score = aligned / jnp.maximum(n_beats, 1.0)

    enough = n_valid >= 2
    score = jnp.where(enough[:, None], score, 0.0)
    max_score = jnp.max(score, axis=-1, keepdims=True)
    conf = jnp.where(max_score > EPSILON, score / jnp.maximum(max_score, EPSILON), 0.0)
    valid = (conf >= 0.1) & enough[:, None]

    key = jnp.where(valid, -conf, jnp.inf)
    order = jnp.argsort(key, axis=-1)
    return CandidateList(
        bpm=jnp.take_along_axis(jnp.broadcast_to(jnp.asarray(grid), conf.shape), order, axis=-1),
        confidence=jnp.take_along_axis(conf, order, axis=-1),
        valid=jnp.take_along_axis(valid, order, axis=-1),
    )


def _octave_correct(ac: CandidateList, comb: CandidateList, octave_tolerance_cents: float):
    """Rewrite autocorr BPMs that sit at 2x / 0.5x of a comb top-3 candidate
    (candidate_filter.rs:147-228). First matching comb candidate wins."""
    tol_ratio = 2.0 ** (octave_tolerance_cents / 1200.0) - 1.0
    comb3_bpm = comb.bpm[:, :3]  # [B, 3]
    comb3_valid = comb.valid[:, :3]
    a = ac.bpm[:, :, None]  # [B, C, 3]
    c = comb3_bpm[:, None, :]
    c_ok = comb3_valid[:, None, :]

    reasonable_c = (c >= REASONABLE_MIN) & (c <= REASONABLE_MAX)
    # 2x pass: ratio = a/c near 2
    m2 = c_ok & (jnp.abs(a / (2.0 * jnp.maximum(c, EPSILON)) - 1.0) < tol_ratio)
    m2 = m2 & (reasonable_c | (a > 200.0) | (a < 30.0))
    first2 = jnp.argmax(m2, axis=-1)
    has2 = jnp.any(m2, axis=-1)
    new_bpm = jnp.where(has2, jnp.take_along_axis(comb3_bpm[:, None, :], first2[..., None], axis=-1)[..., 0], ac.bpm)

    # 0.5x pass on the updated list: ratio = c/a near 2
    a2 = new_bpm[:, :, None]
    m5 = c_ok & (jnp.abs(c / (2.0 * jnp.maximum(a2, EPSILON)) - 1.0) < tol_ratio) & reasonable_c
    first5 = jnp.argmax(m5, axis=-1)
    has5 = jnp.any(m5, axis=-1)
    new_bpm = jnp.where(has5, jnp.take_along_axis(comb3_bpm[:, None, :], first5[..., None], axis=-1)[..., 0], new_bpm)
    return CandidateList(new_bpm, ac.confidence, ac.valid)


def _limit_autocorr(ac: CandidateList) -> CandidateList:
    """Top 10 + re-added reasonable-range candidates not within 1 BPM of an
    already-kept one (candidate_filter.rs:241-269), via a greedy scan."""
    c = ac.bpm.shape[-1]
    idx = jnp.arange(c)
    base_keep = ac.valid & (idx[None, :] < MAX_PER_METHOD)
    reasonable = ac.valid & (ac.bpm >= REASONABLE_MIN) & (ac.bpm <= REASONABLE_MAX)

    def step(kept_bpms, i):
        # kept_bpms: [B, C] of kept values (BIG where not kept)
        bpm_i = ac.bpm[:, i]
        near = jnp.any(jnp.abs(kept_bpms - bpm_i[:, None]) < 1.0, axis=-1)
        keep = base_keep[:, i] | (reasonable[:, i] & ~near)
        kept_bpms = kept_bpms.at[:, i].set(jnp.where(keep, bpm_i, BIG))
        return kept_bpms, keep

    init = jnp.full(ac.bpm.shape, BIG)
    _, keeps = jax.lax.scan(step, init, jnp.arange(c), unroll=8)
    keep = jnp.moveaxis(keeps, 0, 1)
    # compact to AC_CAP slots, preserving order
    order = jnp.argsort(~keep, axis=-1, stable=True)[:, :AC_CAP]
    return CandidateList(
        bpm=jnp.take_along_axis(ac.bpm, order, axis=-1),
        confidence=jnp.take_along_axis(ac.confidence, order, axis=-1),
        valid=jnp.take_along_axis(keep, order, axis=-1),
    )


def merge_bpm_candidates(
    ac: CandidateList, comb: CandidateList, cfg: AnalysisConfig, use_guardrails: bool
):
    """Merge + score (candidate_filter.rs:153-452, mod.rs:226-339).

    Returns dict with bpm [B], confidence [B], method_agreement [B] int32,
    ok [B] (any estimate exists).
    """
    # the promotion candidate is taken from the UNCORRECTED autocorr list,
    # BEFORE merging (mod.rs:272-275 "before merging"); using the octave-
    # corrected list instead changes which estimate gets promoted whenever
    # the correction rewrites ac's top in-range candidate
    ac_orig = ac
    ac = _octave_correct(ac, comb, 50.0)

    # disagreement between the two top picks (candidate_filter.rs:232-240)
    ac_top_ok = ac.valid[:, 0]
    cb_top_ok = comb.valid[:, 0]
    diff = jnp.abs(ac.bpm[:, 0] - comb.bpm[:, 0])
    disagreement = ac_top_ok & cb_top_ok & (diff > 10.0) & (diff < 50.0)

    ac_lim = _limit_autocorr(ac)
    comb_lim = CandidateList(
        comb.bpm[:, :MAX_PER_METHOD],
        comb.confidence[:, :MAX_PER_METHOD],
        comb.valid[:, :MAX_PER_METHOD],
    )

    # --- greedy running-mean grouping over the concatenated list ---
    all_bpm = jnp.concatenate([ac_lim.bpm, comb_lim.bpm], axis=-1)
    all_conf = jnp.concatenate([ac_lim.confidence, comb_lim.confidence], axis=-1)
    all_valid = jnp.concatenate([ac_lim.valid, comb_lim.valid], axis=-1)
    n = all_bpm.shape[-1]
    b = all_bpm.shape[0]

    def gstep(carry, i):
        g_bpm, g_conf, g_cnt, g_max = carry  # [B, n] each; slot j = group j
        v = all_valid[:, i]
        bpm_i = all_bpm[:, i]
        conf_i = all_conf[:, i]
        near = (jnp.abs(bpm_i[:, None] - g_bpm) <= 2.0) & (g_cnt > 0)
        has = jnp.any(near, axis=-1) & v
        tgt = jnp.argmax(near, axis=-1)  # first matching group
        # update existing group
        cnt = jnp.take_along_axis(g_cnt, tgt[:, None], axis=-1)[:, 0]
        mean = jnp.take_along_axis(g_bpm, tgt[:, None], axis=-1)[:, 0]
        new_mean = (mean * cnt + bpm_i) / (cnt + 1.0)
        upd = lambda arr, val: jnp.where(
            (jnp.arange(n)[None, :] == tgt[:, None]) & has[:, None], val[:, None], arr
        )
        g_bpm = upd(g_bpm, new_mean)
        g_conf = upd(g_conf, jnp.take_along_axis(g_conf, tgt[:, None], axis=-1)[:, 0] + conf_i)
        g_cnt = upd(g_cnt, cnt + 1.0)
        g_max = upd(
            g_max, jnp.maximum(jnp.take_along_axis(g_max, tgt[:, None], axis=-1)[:, 0], conf_i)
        )
        # or open new group at slot i
        new = v & ~has
        slot = jnp.arange(n)[None, :] == i
        g_bpm = jnp.where(slot & new[:, None], bpm_i[:, None], g_bpm)
        g_conf = jnp.where(slot & new[:, None], conf_i[:, None], g_conf)
        g_cnt = jnp.where(slot & new[:, None], 1.0, g_cnt)
        g_max = jnp.where(slot & new[:, None], conf_i[:, None], g_max)
        return (g_bpm, g_conf, g_cnt, g_max), None

    zeros = jnp.zeros((b, n))
    (g_bpm, g_conf, g_cnt, g_max), _ = jax.lax.scan(
        gstep, (zeros, zeros, zeros, zeros), jnp.arange(n), unroll=4
    )
    g_valid = g_cnt > 0

    # confidence combine (candidate_filter.rs:316-346)
    both = g_cnt >= 2.0
    avg = g_conf / jnp.maximum(g_cnt, 1.0)
    conf = jnp.where(both, jnp.minimum((avg + g_max) / 2.0 * 1.2, 1.0), jnp.minimum(g_conf, 1.0))
    conf = jnp.where(disagreement[:, None] & (g_cnt == 1.0), conf * 0.7, conf)
    agreement = g_cnt.astype(jnp.int32)

    # consensus boosts vs top-5 lists (candidate_filter.rs:51-112)
    def near_any(cands: CandidateList, est_bpm, tol):
        c5 = cands.bpm[:, :5][:, None, :]
        v5 = cands.valid[:, :5][:, None, :]
        return jnp.any(v5 & (jnp.abs(c5 - est_bpm[:, :, None]) < tol), axis=-1)

    def harmonic_any(cands: CandidateList, est_bpm):
        c5 = cands.bpm[:, :5][:, None, :]
        v5 = cands.valid[:, :5][:, None, :]
        e = jnp.maximum(est_bpm[:, :, None], EPSILON)
        ratio = jnp.maximum(c5 / e, e / jnp.maximum(c5, EPSILON))
        hit = (
            (jnp.abs(ratio - 2.0) < 0.1)
            | (jnp.abs(ratio - 1.5) < 0.1)
            | (jnp.abs(ratio - 0.75) < 0.1)
        )
        return jnp.any(v5 & hit, axis=-1)

    ac_direct = near_any(ac_lim, g_bpm, 2.5)
    cb_direct = near_any(comb_lim, g_bpm, 2.5)
    ac_harm = harmonic_any(ac_lim, g_bpm)
    cb_harm = harmonic_any(comb_lim, g_bpm)
    conf = jnp.where(ac_direct & cb_direct, conf * 1.5,
                     jnp.where((ac_direct & cb_harm) | (cb_direct & ac_harm), conf * 1.3, conf))
    in_range = (g_bpm >= REASONABLE_MIN) & (g_bpm <= REASONABLE_MAX)
    conf = jnp.where(cb_direct & in_range, conf * 1.4, conf)

    # safety boost: no reasonable candidate among the first 5 groups in
    # creation order (candidate_filter.rs:364-381)
    first5 = jnp.arange(n)[None, :] < 5
    has_reasonable_top5 = jnp.any(g_valid & first5 & in_range, axis=-1)
    first_reasonable = jnp.argmax(g_valid & in_range, axis=-1)
    boost_slot = (
        ~has_reasonable_top5[:, None]
        & jnp.any(g_valid & in_range, axis=-1)[:, None]
        & (jnp.arange(n)[None, :] == first_reasonable[:, None])
    )
    conf = jnp.where(boost_slot, conf * 2.0, conf)

    # final ranking (candidate_filter.rs:385-452): effective confidence with
    # out-of-range halving plus the +0.5 in-range preference offset
    eff = jnp.where(in_range, conf, conf * 0.5) + jnp.where(in_range, 0.5, 0.0)
    eff = eff + agreement.astype(jnp.float32) * 1e-4  # agreement tiebreak
    rank_key = jnp.where(g_valid, eff, -jnp.inf)

    if use_guardrails:
        g = _sane_guardrails(cfg)
        mul = jnp.where(
            (g_bpm >= g[0]) & (g_bpm <= g[1]), cfg.legacy_bpm_conf_mul_preferred,
            jnp.where((g_bpm >= g[2]) & (g_bpm <= g[3]), cfg.legacy_bpm_conf_mul_soft,
                      cfg.legacy_bpm_conf_mul_extreme),
        )
        conf = conf * mul
        # guardrail path re-sorts by plain (multiplied) confidence (mod.rs:300-311)
        rank_key = jnp.where(g_valid, conf, -jnp.inf)
        preferred_min, preferred_max = g[0], g[1]
    else:
        preferred_min, preferred_max = REASONABLE_MIN, REASONABLE_MAX

    # prefer autocorr's top preferred-range candidate (mod.rs:272-339):
    # first (confidence-ordered) UNCORRECTED autocorr candidate in range
    acp_ok = ac_orig.valid & (ac_orig.bpm >= preferred_min) & (ac_orig.bpm <= preferred_max)
    acp_idx = jnp.argmax(acp_ok, axis=-1)
    has_acp = jnp.any(acp_ok, axis=-1)
    acp_bpm = jnp.take_along_axis(ac_orig.bpm, acp_idx[:, None], axis=-1)[:, 0]
    match = g_valid & (jnp.abs(g_bpm - acp_bpm[:, None]) < 2.0)
    promote = has_acp[:, None] & match
    rank_key = jnp.where(promote, rank_key + 1e6, rank_key)
    # among promoted, the reference moves the *highest-ranked existing* match
    # to the front — the +1e6 offset preserves relative order within matches

    best = jnp.argmax(rank_key, axis=-1)
    take = lambda a: jnp.take_along_axis(a, best[:, None], axis=-1)[:, 0]
    ok = jnp.any(g_valid, axis=-1)
    return {
        "bpm": jnp.where(ok, take(g_bpm), 0.0),
        "confidence": jnp.where(ok, take(conf), 0.0),
        "method_agreement": jnp.where(ok, take(agreement), 0),
        "ok": ok,
    }


def _sane_guardrails(cfg: AnalysisConfig):
    """clamp_sane (mod.rs:120-148)."""
    pmin = min(cfg.legacy_bpm_preferred_min, cfg.legacy_bpm_preferred_max)
    pmax = max(cfg.legacy_bpm_preferred_min, cfg.legacy_bpm_preferred_max)
    smin = min(cfg.legacy_bpm_soft_min, cfg.legacy_bpm_soft_max, pmin)
    smax = max(cfg.legacy_bpm_soft_min, cfg.legacy_bpm_soft_max, pmax)
    return (pmin, pmax, smin, smax)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def estimate_bpm_legacy(
    onset_pos: jax.Array,
    onset_valid: jax.Array,
    t_padded: int,
    sample_rate: int,
    cfg: AnalysisConfig,
):
    """Full legacy estimate (mod.rs:173-339 ``estimate_bpm[_with_guardrails]``).

    Returns dict bpm/confidence/method_agreement/ok, all [B].
    """
    ac = autocorr_candidates(
        onset_pos, onset_valid, t_padded, sample_rate, cfg.hop_size, cfg.min_bpm, cfg.max_bpm
    )
    comb = comb_candidates(
        onset_pos, onset_valid, t_padded, sample_rate, cfg.min_bpm, cfg.max_bpm, cfg.bpm_resolution
    )
    out = merge_bpm_candidates(ac, comb, cfg, cfg.enable_legacy_bpm_guardrails)
    # orchestrator gate: needs >= 2 onsets (lib.rs:297)
    enough = jnp.sum(onset_valid, axis=-1) >= 2
    out["ok"] = out["ok"] & enough
    return out


def coarse_to_fine_search(
    onset_pos: jax.Array,
    onset_valid: jax.Array,
    t_padded: int,
    sample_rate: int,
    min_bpm: float,
    max_bpm: float,
    refinement_range: float = 5.0,
) -> CandidateList:
    """Two-stage comb search (comb_filter.rs:256-327): coarse 2.0-BPM grid,
    then a 0.5-BPM grid of ±refinement_range around each track's coarse best.

    Batched: the fine stage evaluates a per-track candidate set
    ``coarse_best + offsets`` (the reference re-grids from the best value);
    scoring reuses the comb alignment kernel with traced BPM values.
    """
    coarse = comb_candidates(
        onset_pos, onset_valid, t_padded, sample_rate, min_bpm, max_bpm, 2.0
    )
    best = jnp.where(coarse.valid[:, 0], coarse.bpm[:, 0], 0.0)  # [B]
    n_off = int(2 * refinement_range / 0.5) + 1
    offsets = jnp.asarray(
        np.arange(n_off, dtype=np.float32) * 0.5 - refinement_range
    )
    cand = jnp.clip(best[:, None] + offsets[None, :], min_bpm, max_bpm)  # [B, C]

    period = 60.0 * sample_rate / jnp.maximum(cand, EPSILON)
    tol = jnp.clip(
        COMB_DEFAULT_TOLERANCE * (COMB_REFERENCE_BPM / jnp.maximum(cand, EPSILON)),
        COMB_MIN_TOLERANCE,
        COMB_MAX_TOLERANCE,
    ) * period

    n_beats_cap = int(np.ceil(t_padded / (60.0 * sample_rate / max_bpm))) + 2
    beat_idx = jnp.arange(n_beats_cap, dtype=jnp.float32)
    beats = period[:, :, None] * beat_idx[None, None, :]  # [B, C, NB]

    sorted_pos = jnp.sort(
        jnp.where(onset_valid, onset_pos, jnp.iinfo(jnp.int32).max), axis=-1
    ).astype(jnp.float32)
    n_valid = jnp.sum(onset_valid, axis=-1)
    last = jnp.max(jnp.where(onset_valid, onset_pos, 0), axis=-1).astype(jnp.float32)
    b = onset_pos.shape[0]
    dist = _nearest_onset_distance_sorted(
        beats.reshape(b, -1), sorted_pos, n_valid
    ).reshape(beats.shape)
    n_beats = jnp.ceil(last[:, None] / period) + 1
    beat_ok = beat_idx[None, None, :] < n_beats[:, :, None]
    aligned = jnp.sum((dist <= tol[:, :, None]) & beat_ok, axis=-1)
    score = aligned / jnp.maximum(n_beats, 1.0)

    enough = (n_valid >= 2) & coarse.valid[:, 0]
    score = jnp.where(enough[:, None], score, 0.0)
    mx = jnp.max(score, axis=-1, keepdims=True)
    conf = jnp.where(mx > EPSILON, score / jnp.maximum(mx, EPSILON), 0.0)
    valid = (conf >= 0.1) & enough[:, None]
    order = jnp.argsort(jnp.where(valid, -conf, jnp.inf), axis=-1)
    return CandidateList(
        bpm=jnp.take_along_axis(cand, order, axis=-1),
        confidence=jnp.take_along_axis(conf, order, axis=-1),
        valid=jnp.take_along_axis(valid, order, axis=-1),
    )
