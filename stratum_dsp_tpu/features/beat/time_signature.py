"""Time-signature detection (batched).

Mirror of reference ``beat_tracking/time_signature.rs:90-205``: positive beat
intervals; for each hypothesis lag L in {4, 3, 6}, mean similarity
``1/(1 + |v[i]-v[i+L]|/mean)`` plus a consistency term ``1/(1+cv)`` weighted
0.7/0.3; < 8 beats defaults to 4/4 at confidence 0.5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPSILON = 1e-10
BIG = 1e9
TIE_EPS = 1e-4

FOUR_FOUR, THREE_FOUR, SIX_EIGHT = 0, 1, 2
# tuple, not jnp array: a module-level device constant would initialize
# the JAX backend at import time (breaks the dryrun's platform forcing)
BEATS_PER_BAR = (4.0, 3.0, 6.0)
HYPOTHESIS_LAGS = (4, 3, 6)


def positive_intervals(times: jax.Array, n: jax.Array):
    """Consecutive diffs of the compacted beat list, keeping only > 0
    (time_signature.rs:107-113). Compacted to a prefix via sort keyed on
    validity order (diffs of a sorted list stay sorted? no — but the
    reference keeps original order; our compaction preserves it since only
    invalid entries are removed)."""
    mb = times.shape[-1]
    d = times[:, 1:] - times[:, :-1]
    ok = (jnp.arange(mb - 1)[None, :] < (n - 1)[:, None]) & (d > 0.0)
    # compact: stable argsort on ~ok keeps relative order of kept intervals
    order = jnp.argsort(~ok, axis=-1, stable=True)
    dc = jnp.take_along_axis(jnp.where(ok, d, 0.0), order, axis=-1)
    return dc, jnp.sum(ok, axis=-1)


def detect_time_signature(times: jax.Array, valid: jax.Array, n_beats: jax.Array):
    """Returns (sig_index [B] int32 in {0=4/4, 1=3/4, 2=6/8}, confidence [B]).

    ``times`` must be the compacted (invalid-last) sorted beat list.
    """
    v, m = positive_intervals(times, n_beats)
    nmax = v.shape[-1]
    mf = jnp.maximum(m, 1).astype(jnp.float32)
    imask = jnp.arange(nmax)[None, :] < m[:, None]
    mean = jnp.sum(jnp.where(imask, v, 0.0), axis=-1) / mf
    var = jnp.sum(jnp.where(imask, (v - mean[:, None]) ** 2, 0.0), axis=-1) / mf
    cv = jnp.where(mean > EPSILON, jnp.sqrt(var) / mean, 1.0)
    consistency = 1.0 / (1.0 + cv)

    scores = []
    for lag in HYPOTHESIS_LAGS:
        cnt = jnp.maximum(m - lag, 0)
        pair_ok = imask & (jnp.arange(nmax)[None, :] < cnt[:, None])
        diff = jnp.abs(v - jnp.roll(v, -lag, axis=-1))
        sim = 1.0 / (1.0 + diff / jnp.maximum(mean[:, None], EPSILON))
        ac = jnp.sum(jnp.where(pair_ok, sim, 0.0), axis=-1) / jnp.maximum(cnt, 1)
        score = jnp.minimum(ac * 0.7 + consistency * 0.3, 1.0)
        score = jnp.where((m >= lag) & (cnt > 0), score, 0.0)
        scores.append(score)
    scores = jnp.stack(scores, axis=-1)  # [B, 3]

    # Tie-stable pick: on a filled, drift-fitted lattice the beat intervals
    # are constant up to f32 dust, all three hypotheses score ~1.0, and a
    # plain argmax would pick by the dust — which differs between CPU and GPU
    # reduction orders. Scores within TIE_EPS of the best are tied and the
    # first hypothesis (4/4, the reference's order and its fallback) wins.
    best = jnp.argmax(
        scores >= jnp.max(scores, axis=-1, keepdims=True) - TIE_EPS, axis=-1
    ).astype(jnp.int32)
    conf = jnp.clip(jnp.max(scores, axis=-1), 0.0, 1.0)

    fallback = n_beats < 8
    return (
        jnp.where(fallback, FOUR_FOUR, best),
        jnp.where(fallback, 0.5, conf),
    )
