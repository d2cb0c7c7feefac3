"""Core key-scoring math (batched over arbitrary leading dims).

Mirror of reference ``features/key/detector.rs``:

* raw scores: weighted sum of per-frame chroma·template dot products
  (detector.rs:114-133, 984-1001)
* per-mode max normalization (detector.rs:135-167)
* circle-of-fifths neighbor bonus: keys within circular distance 2 of the
  mode's top key gain ``top_score * 0.20 * (1 - dist/2)`` (detector.rs:169-243)
* best key + confidence = (best - best_other)/best (detector.rs:276-293).
  The reference's "weighted top-3 voting" is provably a no-op (each key
  appears once, vote weight is monotonic in score), so best == argmax.
* clarity = (max - mean)/range over the 24 scores (key_clarity.rs:51-93)
* mode heuristic: 3rd/6th/7th-degree discrimination with a gated
  parallel-mode flip and optional minor leading-tone bonus
  (detector.rs:326-518)

Score layout: ``[..., 24]`` = major C..B then minor C..B.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

EPSILON = 1e-9
CIRCLE_OF_FIFTHS = (0, 7, 2, 9, 4, 11, 6, 1, 8, 3, 10, 5)
CIRCLE_BONUS_WEIGHT = 0.20


# Epsilon for tie-stable argmaxes over key scores. The per-mode max
# normalization + self-bonus make the best major and best minor key tie at
# EXACTLY 1.2 in exact arithmetic (detector.rs:135-243), so the mode
# decision rides entirely on the tie-break: the reference's stable
# descending sort over a majors-then-minors table (detector.rs:244-246).
# f32 accumulation dust (~2e-7 relative; the score contractions run at
# HIGHEST precision so GPU TF32 never enters) would otherwise break these
# ties at random per platform; scores within TIE_EPS of the max are treated
# as tied and the FIRST index wins — far below any
# meaningful key separation (the 3rd-place score is typically >0.1 lower).
TIE_EPS = 1e-4


def stable_argmax(scores: jax.Array, eps: float = TIE_EPS) -> jax.Array:
    """First index whose score is within ``eps`` of the max (platform-robust
    realization of the reference's stable-sort tie-break)."""
    mx = jnp.max(scores, axis=-1, keepdims=True)
    return jnp.argmax(scores >= mx - eps, axis=-1)


@functools.lru_cache(maxsize=1)
def _cof_bonus_matrix() -> np.ndarray:
    """[12, 12] bonus factor between tonics: 0.20*(1-dist*0.5) for circular
    circle-of-fifths distance <= 2, else 0."""
    pos = np.zeros(12, dtype=np.int64)
    for p, tonic in enumerate(CIRCLE_OF_FIFTHS):
        pos[tonic] = p
    d = np.abs(pos[:, None] - pos[None, :])
    d = np.minimum(d, 12 - d)
    return np.where(d <= 2, CIRCLE_BONUS_WEIGHT * (1.0 - d * 0.5), 0.0).astype(np.float32)


def raw_scores(
    chroma: jax.Array, weights: Optional[jax.Array], templates: jax.Array
) -> jax.Array:
    """Weighted sum-of-dots scores [..., 24] from chroma [..., F, 12]."""
    if weights is not None:
        chroma = chroma * weights[..., None]
    return jnp.einsum(
        "...fc,kc->...k", chroma, templates, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def finalize_scores(scores: jax.Array) -> jax.Array:
    """Per-mode max normalization + circle-of-fifths bonus."""
    major, minor = scores[..., :12], scores[..., 12:]
    max_major = jnp.max(major, axis=-1, keepdims=True)
    max_minor = jnp.max(minor, axis=-1, keepdims=True)
    do_norm = (max_major > EPSILON) & (max_minor > EPSILON)
    major = jnp.where(do_norm, major / jnp.maximum(max_major, EPSILON), major)
    minor = jnp.where(do_norm, minor / jnp.maximum(max_minor, EPSILON), minor)

    bonus = jnp.asarray(_cof_bonus_matrix())
    top_major_tonic = stable_argmax(major)
    top_minor_tonic = stable_argmax(minor)
    top_major_score = jnp.max(major, axis=-1, keepdims=True)
    top_minor_score = jnp.max(minor, axis=-1, keepdims=True)
    bM = jnp.take(bonus, top_major_tonic, axis=0)  # [..., 12]
    bm = jnp.take(bonus, top_minor_tonic, axis=0)
    major = major + jnp.where(top_major_score > EPSILON, top_major_score * bM, 0.0)
    minor = minor + jnp.where(top_minor_score > EPSILON, top_minor_score * bm, 0.0)
    return jnp.concatenate([major, minor], axis=-1)


def best_key_confidence(scores: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(key_idx int32, confidence) where confidence = (best-second)/best.

    Tie-break is first-index (major keys win over minor on exact ties), which
    reproduces the reference's stable descending sort over a
    majors-then-minors table (detector.rs:244-246) — this matters because the
    per-mode normalization + self-bonus makes the two mode maxima tie at 1.2
    exactly. ``stable_argmax`` (first occurrence within TIE_EPS of the max)
    is used instead of ``top_k``/plain argmax, whose tie behavior is
    backend- and rounding-dust-dependent.
    """
    key_idx = stable_argmax(scores).astype(jnp.int32)
    best = jnp.take_along_axis(scores, key_idx[..., None], axis=-1)[..., 0]
    masked = jnp.where(jax.nn.one_hot(key_idx, scores.shape[-1], dtype=bool), -jnp.inf, scores)
    second = jnp.max(masked, axis=-1)
    conf = jnp.where(best > 0.0, jnp.clip((best - second) / jnp.maximum(best, EPSILON), 0.0, 1.0), 0.0)
    return key_idx, conf


def key_clarity(scores: jax.Array) -> jax.Array:
    """(best - mean) / (max - min), clamped (key_clarity.rs:51-93)."""
    best = jnp.max(scores, axis=-1)
    mean = jnp.mean(scores, axis=-1)
    rng = best - jnp.min(scores, axis=-1)
    return jnp.where(rng > 1e-10, jnp.clip((best - mean) / jnp.maximum(rng, 1e-10), 0.0, 1.0), 0.0)


def confidence_for_key(scores: jax.Array, key_idx: jax.Array) -> jax.Array:
    """(score[key] - best_other)/score[key] (detector.rs:493-508)."""
    chosen = jnp.take_along_axis(scores, key_idx[..., None], axis=-1)[..., 0]
    masked = jnp.where(
        jax.nn.one_hot(key_idx, 24, dtype=bool), -jnp.inf, scores
    )
    other = jnp.max(masked, axis=-1)
    return jnp.where(
        chosen > 0.0, jnp.clip((chosen - other) / jnp.maximum(chosen, EPSILON), 0.0, 1.0), 0.0
    )


def mode_heuristic(
    scores: jax.Array,
    avg_chroma: jax.Array,
    wsum: jax.Array,
    third_ratio_margin: float,
    flip_min_score_ratio: float,
    enable_minor_harmonic_bonus: bool,
    minor_leading_tone_bonus_weight: float,
):
    """Apply the minor-bonus + mode-flip heuristic (detector.rs:326-518).

    ``avg_chroma [..., 12]`` is the weighted mean chroma (pre-normalization);
    ``wsum`` its weight sum. Returns (key_idx, confidence, scores').
    """
    flip_ratio = float(np.clip(flip_min_score_ratio, 0.0, 1.0))
    enable_flip = flip_ratio > 0.0

    s = jnp.sum(avg_chroma, axis=-1, keepdims=True)
    avg = jnp.where(s > EPSILON, avg_chroma / jnp.maximum(s, EPSILON), avg_chroma)
    heur_ok = wsum > EPSILON

    if enable_minor_harmonic_bonus and minor_leading_tone_bonus_weight > 0.0:
        w = float(max(minor_leading_tone_bonus_weight, 0.0))
        tonics = jnp.arange(12)
        lt = jnp.take(avg, (tonics + 11) % 12, axis=-1)
        b7 = jnp.take(avg, (tonics + 10) % 12, axis=-1)
        bonus = wsum[..., None] * w * (lt - b7)
        minor = scores[..., 12:] + jnp.where(heur_ok[..., None], bonus, 0.0)
        scores = jnp.concatenate([scores[..., :12], minor], axis=-1)

    best_idx = stable_argmax(scores)
    tonic = best_idx % 12
    best_is_major = best_idx < 12

    def deg(offset):
        return jnp.take_along_axis(avg, ((tonic + offset) % 12)[..., None], axis=-1)[..., 0]

    p_min3, p_maj3 = deg(3), deg(4)
    p_min6, p_maj6 = deg(8), deg(9)
    p_min7, p_maj7 = deg(10), deg(11)
    margin = float(max(third_ratio_margin, 0.0))

    def pair(lo, hi, w):
        d = jnp.abs(lo - hi)
        minor_wins = lo > hi * (1.0 + margin)
        major_wins = hi > lo * (1.0 + margin)
        return jnp.where(minor_wins, d * w, 0.0), jnp.where(major_wins, d * w, 0.0)

    m3, M3 = pair(p_min3, p_maj3, 2.0)
    m6, M6 = pair(p_min6, p_maj6, 1.0)
    m7, M7 = pair(p_min7, p_maj7, 1.0)
    minor_score = m3 + m6 + m7
    major_score = M3 + M6 + M7
    total = minor_score + major_score
    minor_pref = (total > EPSILON) & (minor_score > major_score * (1.0 + margin * 0.5))
    major_pref = (total > EPSILON) & (major_score > minor_score * (1.0 + margin * 0.5))

    maj_s = jnp.take_along_axis(scores, tonic[..., None], axis=-1)[..., 0]
    min_s = jnp.take_along_axis(scores, (tonic + 12)[..., None], axis=-1)[..., 0]

    flip_to_minor = (
        enable_flip & heur_ok & best_is_major & minor_pref & (maj_s > 0.0) & (min_s >= maj_s * flip_ratio)
    )
    flip_to_major = (
        enable_flip & heur_ok & ~best_is_major & major_pref & (min_s > 0.0) & (maj_s >= min_s * flip_ratio)
    )
    chosen = jnp.where(
        flip_to_minor, tonic + 12, jnp.where(flip_to_major, tonic, best_idx)
    ).astype(jnp.int32)
    conf = confidence_for_key(scores, chosen)
    return chosen, conf, scores
