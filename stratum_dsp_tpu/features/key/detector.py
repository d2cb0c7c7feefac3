"""Key detection drivers: full-track, segment voting, multi-scale, median,
ensemble (batched, fixed segment capacity).

Mirror of reference ``features/key/detector.rs`` and the orchestrator's
segment-voting block (lib.rs:1332-1436). All segmented variants share one
trick: per-frame template scores ``chroma @ T^T`` (and weighted chroma sums
for the mode heuristic) are prefix-summed once over the frame axis, so every
segment's raw scores come from two gathers — segments never touch frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import AnalysisConfig, TemplateSet
from . import scoring
from .templates import key_templates

EPSILON = 1e-9


class KeyResult(NamedTuple):
    """Batched key result (arrays of leading shape [B] / [B, 24])."""

    key_idx: jax.Array  # [B] int32, 0-11 major / 12-23 minor
    confidence: jax.Array  # [B]
    clarity: jax.Array  # [B]
    scores: jax.Array  # [B, 24]


def _weighted(chroma, weights, frame_mask):
    w = jnp.ones(chroma.shape[:-1], chroma.dtype) if weights is None else weights
    return w * frame_mask


def detect_key_weighted(
    chroma: jax.Array,
    weights: Optional[jax.Array],
    frame_mask: jax.Array,
    cfg: AnalysisConfig,
    templates: Optional[np.ndarray] = None,
) -> KeyResult:
    """Full-track weighted detection (detector.rs:68-300), with the mode
    heuristic / minor bonus applied when enabled (detector.rs:326-518)."""
    t = jnp.asarray(key_templates(cfg.key_template_set) if templates is None else templates)
    w = _weighted(chroma, weights, frame_mask)
    raw = scoring.raw_scores(chroma, w, t)
    scores = scoring.finalize_scores(raw)

    if cfg.enable_key_mode_heuristic or cfg.enable_key_minor_harmonic_bonus:
        avg = jnp.einsum(
            "...f,...fc->...c", w, chroma, precision=jax.lax.Precision.HIGHEST
        )
        wsum = jnp.sum(w, axis=-1)
        key_idx, conf, scores = scoring.mode_heuristic(
            scores,
            avg,
            wsum,
            cfg.key_mode_third_ratio_margin,
            cfg.key_mode_flip_min_score_ratio if cfg.enable_key_mode_heuristic else 0.0,
            cfg.enable_key_minor_harmonic_bonus,
            cfg.key_minor_leading_tone_bonus_weight,
        )
    else:
        key_idx, conf = scoring.best_key_confidence(scores)
    return KeyResult(key_idx, conf, scoring.key_clarity(scores), scores)


class SegmentPrefixes:
    """Prefix sums enabling O(1) per-segment scoring."""

    def __init__(self, chroma, weights, frame_mask, templates):
        w = _weighted(chroma, weights, frame_mask)
        frame_scores = jnp.einsum(
            "...fc,kc->...fk", chroma, templates, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        z = lambda x: jnp.concatenate([jnp.zeros_like(x[..., :1, :]), jnp.cumsum(x, axis=-2)], axis=-2)
        self.p_scores = z(w[..., None] * frame_scores)  # [B, F+1, 24]
        self.p_chroma = z(w[..., None] * chroma)  # [B, F+1, 12]
        pw = jnp.cumsum(w, axis=-1)
        self.p_w = jnp.concatenate([jnp.zeros_like(pw[..., :1]), pw], axis=-1)  # [B, F+1]
        self.n_frames_padded = chroma.shape[-2]

    def segment(self, starts: jax.Array, seg_len: int):
        """Per-segment (raw_scores [B,S,24], avg_chroma [B,S,12], wsum [B,S])
        for static ``starts [S]``."""
        ends = starts + seg_len
        gs = lambda p: jnp.take(p, ends, axis=-2) - jnp.take(p, starts, axis=-2)
        raw = gs(self.p_scores)
        avg = gs(self.p_chroma)
        wsum = jnp.take(self.p_w, ends, axis=-1) - jnp.take(self.p_w, starts, axis=-1)
        return raw, avg, wsum


def _segment_results(raw, avg, wsum, cfg: AnalysisConfig):
    """Finalize per-segment scores (+ heuristic) and compute clarity."""
    scores = scoring.finalize_scores(raw)
    if cfg.enable_key_mode_heuristic or cfg.enable_key_minor_harmonic_bonus:
        _, _, scores = scoring.mode_heuristic(
            scores,
            avg,
            wsum,
            cfg.key_mode_third_ratio_margin,
            cfg.key_mode_flip_min_score_ratio if cfg.enable_key_mode_heuristic else 0.0,
            cfg.enable_key_minor_harmonic_bonus,
            cfg.key_minor_leading_tone_bonus_weight,
        )
    return scores, scoring.key_clarity(scores)


def _accumulated_result(acc_scores, used_any, fallback: KeyResult) -> KeyResult:
    key_idx, conf = scoring.best_key_confidence(acc_scores)
    clarity = scoring.key_clarity(acc_scores)
    return KeyResult(
        key_idx=jnp.where(used_any, key_idx, fallback.key_idx),
        confidence=jnp.where(used_any, conf, fallback.confidence),
        clarity=jnp.where(used_any, clarity, fallback.clarity),
        scores=jnp.where(used_any[..., None], acc_scores, fallback.scores),
    )


def detect_key_segment_voting(
    chroma: jax.Array,
    weights: Optional[jax.Array],
    frame_mask: jax.Array,
    n_frames: jax.Array,
    cfg: AnalysisConfig,
) -> KeyResult:
    """The orchestrator's clarity-weighted segment voting
    (lib.rs:1337-1436): windows of ``key_segment_len_frames`` every
    ``key_segment_hop_frames``; segments with clarity >= threshold
    accumulate their full score tables weighted by clarity; empty ->
    full-track fallback."""
    t = jnp.asarray(key_templates(cfg.key_template_set))
    f = chroma.shape[-2]
    seg_len = min(max(cfg.key_segment_len_frames, 1), f)
    hop = max(min(cfg.key_segment_hop_frames, seg_len), 1)
    min_clarity = float(np.clip(cfg.key_segment_min_clarity, 0.0, 1.0))

    # reference gate (lib.rs:1337-1340): voting only when the track has
    # enough frames and seg_len >= 120
    gate_static = cfg.enable_key_segment_voting and cfg.key_segment_len_frames >= 120
    fallback = detect_key_weighted(chroma, weights, frame_mask, cfg)
    if not gate_static:
        return fallback

    starts = np.arange(0, max(f - seg_len, 0) + 1, hop)
    pre = SegmentPrefixes(chroma, weights, frame_mask, t)
    raw, avg, wsum = pre.segment(jnp.asarray(starts), seg_len)
    scores, clarity = _segment_results(raw, avg, wsum, cfg)

    # per-track validity: start + seg_len <= n_frames; also reference
    # requires chroma len >= seg_len (data-dependent; mirrors lib.rs:1338)
    seg_valid = (jnp.asarray(starts)[None, :] + seg_len) <= n_frames[:, None]
    use = seg_valid & (clarity >= min_clarity)
    acc = jnp.sum(jnp.where(use[..., None], scores * clarity[..., None], 0.0), axis=-2)
    used_any = jnp.any(use, axis=-1) & (n_frames >= seg_len)
    return _accumulated_result(acc, used_any, fallback)


def detect_key_multi_scale(
    chroma: jax.Array,
    weights: Optional[jax.Array],
    frame_mask: jax.Array,
    n_frames: jax.Array,
    cfg: AnalysisConfig,
) -> KeyResult:
    """Multi-scale clarity×scale-weighted voting (detector.rs:546-700):
    accumulated scores are normalized by total weight before ranking."""
    t = jnp.asarray(key_templates(cfg.key_template_set))
    f = chroma.shape[-2]
    hop = max(cfg.key_multi_scale_hop, 1)
    min_clarity = float(np.clip(cfg.key_multi_scale_min_clarity, 0.0, 1.0))
    scale_weights = cfg.key_multi_scale_weights or tuple(
        1.0 for _ in cfg.key_multi_scale_lengths
    )
    pre = SegmentPrefixes(chroma, weights, frame_mask, t)
    fallback = detect_key_weighted(chroma, weights, frame_mask, cfg)

    acc = jnp.zeros(chroma.shape[:-2] + (24,), jnp.float32)
    total_w = jnp.zeros(chroma.shape[:-2], jnp.float32)
    used_any = jnp.zeros(chroma.shape[:-2], bool)
    for scale_idx, seg_len in enumerate(cfg.key_multi_scale_lengths):
        sw = scale_weights[scale_idx] if scale_idx < len(scale_weights) else 1.0
        if seg_len <= 0 or seg_len > f or sw <= 0.0:
            continue
        starts = np.arange(0, max(f - seg_len, 0) + 1, hop)
        raw, avg, wsum = pre.segment(jnp.asarray(starts), seg_len)
        scores, clarity = _segment_results(raw, avg, wsum, cfg)
        seg_valid = (jnp.asarray(starts)[None, :] + seg_len) <= n_frames[:, None]
        use = seg_valid & (clarity >= min_clarity)
        cw = clarity * sw
        acc = acc + jnp.sum(jnp.where(use[..., None], scores * cw[..., None], 0.0), axis=-2)
        total_w = total_w + jnp.sum(jnp.where(use, cw, 0.0), axis=-1)
        used_any = used_any | jnp.any(use, axis=-1)

    acc = acc / jnp.maximum(total_w, 1e-12)[..., None]
    return _accumulated_result(acc, used_any & (total_w > 1e-12), fallback)


def detect_key_median(
    chroma: jax.Array,
    weights: Optional[jax.Array],
    frame_mask: jax.Array,
    n_frames: jax.Array,
    cfg: AnalysisConfig,
) -> KeyResult:
    """Median-key segmentation (detector.rs:721-863): the most frequent
    per-segment key (total confidence as tiebreak) wins; confidence from the
    confidence-weighted aggregate score table."""
    t = jnp.asarray(key_templates(cfg.key_template_set))
    f = chroma.shape[-2]
    seg_len = max(min(cfg.key_median_segment_length_frames, f), 120)
    hop = max(cfg.key_median_segment_hop_frames, 1)
    min_seg = max(cfg.key_median_min_segments, 1)
    fallback = detect_key_weighted(chroma, weights, frame_mask, cfg)
    if seg_len > f:
        return fallback

    starts = np.arange(0, max(f - seg_len, 0) + 1, hop)
    pre = SegmentPrefixes(chroma, weights, frame_mask, t)
    raw, _avg, _wsum = pre.segment(jnp.asarray(starts), seg_len)
    scores = scoring.finalize_scores(raw)
    key_idx, conf = scoring.best_key_confidence(scores)
    seg_valid = (jnp.asarray(starts)[None, :] + seg_len) <= n_frames[:, None]

    onehot = jax.nn.one_hot(key_idx, 24) * seg_valid[..., None]
    counts = jnp.sum(onehot, axis=-2)  # [B, 24]
    conf_sums = jnp.sum(onehot * conf[..., None], axis=-2)
    # max by (count, total_conf): lexicographic via count + conf/large
    rank = counts + conf_sums / (1.0 + jnp.sum(conf_sums, axis=-1, keepdims=True))
    median_key = jnp.argmax(rank, axis=-1).astype(jnp.int32)

    agg_num = jnp.sum(jnp.where(seg_valid[..., None], scores * conf[..., None], 0.0), axis=-2)
    agg_den = jnp.sum(jnp.where(seg_valid, conf, 0.0), axis=-1)
    agg = agg_num / jnp.maximum(agg_den, 1e-12)[..., None]
    confidence = scoring.confidence_for_key(agg, median_key)
    clarity = scoring.key_clarity(agg)

    n_segments = jnp.sum(seg_valid, axis=-1)
    enough = n_segments >= min_seg
    return KeyResult(
        key_idx=jnp.where(enough, median_key, fallback.key_idx),
        confidence=jnp.where(enough, confidence, fallback.confidence),
        clarity=jnp.where(enough, clarity, fallback.clarity),
        scores=jnp.where(enough[..., None], agg, fallback.scores),
    )


def detect_key_ensemble(
    chroma: jax.Array,
    weights: Optional[jax.Array],
    frame_mask: jax.Array,
    cfg: AnalysisConfig,
) -> KeyResult:
    """KK + Temperley weighted score blend (detector.rs:881-976)."""
    total = cfg.key_ensemble_kk_weight + cfg.key_ensemble_temperley_weight
    kk_w = cfg.key_ensemble_kk_weight / total if total > 1e-9 else 0.5
    tp_w = cfg.key_ensemble_temperley_weight / total if total > 1e-9 else 0.5
    kk = detect_key_weighted(
        chroma, weights, frame_mask, cfg, key_templates(TemplateSet.KRUMHANSL_KESSLER)
    )
    tp = detect_key_weighted(
        chroma, weights, frame_mask, cfg, key_templates(TemplateSet.TEMPERLEY)
    )
    combined = kk_w * kk.scores + tp_w * tp.scores
    key_idx, conf = scoring.best_key_confidence(combined)
    return KeyResult(key_idx, conf, scoring.key_clarity(combined), combined)


def detect_key_changes(
    chroma: jax.Array,
    weights: Optional[jax.Array],
    frame_mask: jax.Array,
    n_frames: jax.Array,
    cfg: AnalysisConfig,
    frame_rate: float,
    segment_duration_s: float = 8.0,
    segment_overlap_s: float = 2.0,
):
    """Segment-wise key timeline (key_changes.rs:70-140). Returns
    (timestamps [S], key_idx [B, S], confidence [B, S], seg_valid [B, S],
    primary_key [B])."""
    t = jnp.asarray(key_templates(cfg.key_template_set))
    f = chroma.shape[-2]
    seg_frames = max(int(segment_duration_s * frame_rate), 1)
    hop_frames = max(seg_frames - int(segment_overlap_s * frame_rate), 1)
    seg_frames = min(seg_frames, f)
    starts = np.arange(0, max(f - seg_frames, 0) + 1, hop_frames)

    pre = SegmentPrefixes(chroma, weights, frame_mask, t)
    raw, _avg, _wsum = pre.segment(jnp.asarray(starts), seg_frames)
    scores = scoring.finalize_scores(raw)
    key_idx, conf = scoring.best_key_confidence(scores)
    seg_valid = (jnp.asarray(starts)[None, :] + seg_frames) <= n_frames[:, None]

    onehot = jax.nn.one_hot(key_idx, 24) * seg_valid[..., None]
    counts = jnp.sum(onehot, axis=-2)
    conf_sums = jnp.sum(onehot * conf[..., None], axis=-2)
    rank = counts + conf_sums / (1.0 + jnp.sum(conf_sums, axis=-1, keepdims=True))
    primary = jnp.argmax(rank, axis=-1).astype(jnp.int32)
    timestamps = starts.astype(np.float32) / frame_rate
    return timestamps, key_idx, conf, seg_valid, primary
