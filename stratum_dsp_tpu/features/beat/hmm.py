"""HMM-Viterbi beat tracking (batched, fixed capacity).

Mirror of reference ``beat_tracking/hmm.rs``: a 5-state tempo HMM
(±10% in 5% steps, hmm.rs:162-174), transitions 0.7 self / 0.15 adjacent
(hmm.rs:184-219), Gaussian emissions on distance-to-nearest-onset with
σ = 25 ms (hmm.rs:54-58, 231-298), Viterbi decode, and beat extraction at
frames with emission > 0.1 with confidence 0.7·emission + 0.3·alignment
(hmm.rs:383-441).

Batching notes:

* Beat frames are a fixed-capacity grid ``[B, MAX_BEATS]`` at the *nominal*
  beat interval anchored at the first onset; per-track frame counts mask the
  tail (the reference's ``num_frames`` is data-dependent, hmm.rs:247-249).
* The reference's emission is state-independent (its per-state beat interval
  is computed but unused, hmm.rs:268-270), so the extracted beats do not
  depend on the decoded path; the Viterbi scan is still run (lax.scan over
  the frame axis, [B, 5] carries, multiplicative f32 probabilities exactly
  like hmm.rs:308-375) so path/state outputs stay faithful.
* Distance-to-nearest-onset uses searchsorted on the sorted onset list
  instead of the reference's O(T·K) scan.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

NUM_STATES = 5
STATE_MULTIPLIERS = (0.90, 0.95, 1.00, 1.05, 1.10)
TIMING_TOLERANCE_S = 0.05
EMISSION_SIGMA = TIMING_TOLERANCE_S / 2.0
EMISSION_THRESHOLD = 0.1
EPSILON = 1e-10
BIG = 1e9


class BeatTensor(NamedTuple):
    """Fixed-capacity beat list."""

    times: jax.Array  # [B, MB] seconds
    confidence: jax.Array  # [B, MB]
    valid: jax.Array  # [B, MB] bool


def transition_matrix() -> jnp.ndarray:
    """Row-normalized 0.7/0.15 band matrix (hmm.rs:184-219)."""
    i = jnp.arange(NUM_STATES)[:, None]
    j = jnp.arange(NUM_STATES)[None, :]
    d = jnp.abs(i - j)
    m = jnp.where(d == 0, 0.7, jnp.where(d == 1, 0.15, 0.0))
    return m / jnp.sum(m, axis=1, keepdims=True)


def nearest_onset_distance(query_times: jax.Array, onset_times: jax.Array, onset_valid: jax.Array):
    """|query - nearest valid onset| via searchsorted.

    query_times [B, T]; onset_times [B, K] sorted ascending among valid
    entries; invalid entries must sort last. Rows with zero valid onsets
    return BIG.
    """
    k = onset_times.shape[-1]
    sorted_onsets = jnp.where(onset_valid, onset_times, BIG)
    n_valid = jnp.sum(onset_valid, axis=-1)

    def per_row(q, o, nv):
        idx = jnp.searchsorted(o, q)
        lo = jnp.clip(idx - 1, 0, k - 1)
        hi = jnp.clip(idx, 0, k - 1)
        d_lo = jnp.where(idx > 0, jnp.abs(q - o[lo]), BIG)
        d_hi = jnp.where(idx < nv, jnp.abs(q - o[hi]), BIG)
        return jnp.minimum(d_lo, d_hi)

    return jax.vmap(per_row)(query_times, sorted_onsets, n_valid)


def viterbi_decode(emission: jax.Array) -> jax.Array:
    """Most likely state path ``[B, T] int32`` for state-independent
    emissions ``[B, T]`` (hmm.rs:308-375): multiplicative f32 forward pass
    with a uniform prior, first-index argmax on ties, then backtrack."""
    b, t = emission.shape
    trans = transition_matrix()  # [S, S]
    em_t = jnp.broadcast_to(emission[:, :, None], (b, t, NUM_STATES))

    def fwd(carry, em):
        # carry: [B, S] best path prob; em: [B, S]
        scores = carry[:, :, None] * trans[None, :, :]  # [B, prev, s]
        best_prev = jnp.argmax(scores, axis=1)  # [B, S]
        best_prob = jnp.max(scores, axis=1)
        return best_prob * em, best_prev

    init = jnp.full((b, NUM_STATES), 1.0 / NUM_STATES) * em_t[:, 0]
    last_probs, backptrs = jax.lax.scan(fwd, init, jnp.moveaxis(em_t[:, 1:], 1, 0))
    final_state = jnp.argmax(last_probs, axis=-1)  # [B]

    def back(state, bp):
        prev = jnp.take_along_axis(bp, state[:, None], axis=-1)[:, 0]
        return prev, prev

    _, rev_states = jax.lax.scan(back, final_state, jnp.flip(backptrs, axis=0))
    return jnp.concatenate(
        [jnp.flip(jnp.moveaxis(rev_states, 0, 1), axis=1), final_state[:, None]], axis=1
    )


@functools.partial(jax.jit, static_argnums=(3, 6))
def track_beats(
    bpm: jax.Array,
    onset_times: jax.Array,
    onset_valid: jax.Array,
    max_beats: int,
    anchor: jax.Array | None = None,
    interval_scale: jax.Array | None = None,
    fill: bool = False,
):
    """Track beats for a batch. Returns (BeatTensor, states [B, MB] int32).

    ``bpm [B]`` nominal tempo; ``onset_times [B, K]`` seconds (sorted,
    masked). Tracks with < 1 valid onset or invalid BPM yield empty beats
    (the reference errors; we mask, hmm.rs:122-133).

    ``anchor`` ([B] seconds, optional) overrides the grid's phase anchor.
    Default (None) is the reference convention — the first detected onset
    (hmm.rs:241-249) — whose phase is wrong whenever the first onset is not
    on-beat (e.g. a track-opening event missed by the flux derivative and
    an offbeat hat detected first). ``enable_beat_phase_search`` supplies a
    novelty-optimized anchor instead.
    """
    b = bpm.shape[0]
    n_onsets = jnp.sum(onset_valid, axis=-1)
    ok = (bpm > EPSILON) & (bpm <= 300.0) & (n_onsets >= 1)

    safe_bpm = jnp.where(ok, bpm, 120.0)
    beat_interval = 60.0 / safe_bpm  # [B]
    if interval_scale is not None:
        # drift-fitted interval (grid.fit_grid_drift): bounded within 2% of
        # nominal, so num_frames/emission logic is unaffected structurally
        beat_interval = beat_interval * interval_scale
    start = jnp.min(jnp.where(onset_valid, onset_times, BIG), axis=-1)
    end = jnp.max(jnp.where(onset_valid, onset_times, -BIG), axis=-1)
    if anchor is not None:
        start = anchor
    start = jnp.where(ok, start, 0.0)
    end = jnp.where(ok, end, 0.0)
    num_frames = jnp.ceil(jnp.maximum(end - start, 0.0) / beat_interval).astype(jnp.int32) + 1
    num_frames = jnp.where(ok, jnp.minimum(num_frames, max_beats), 0)

    t_idx = jnp.arange(max_beats, dtype=jnp.float32)
    beat_times = start[:, None] + t_idx[None, :] * beat_interval[:, None]  # [B, MB]
    frame_valid = t_idx[None, :] < num_frames[:, None]

    dist = nearest_onset_distance(beat_times, onset_times, onset_valid)
    emission = jnp.exp(-(dist * dist) / (2.0 * EMISSION_SIGMA * EMISSION_SIGMA))
    emission = jnp.where(frame_valid, emission, 0.0)

    # Viterbi (multiplicative, f32, like the reference; emissions are
    # state-independent so this only determines the reported state sequence)
    states = viterbi_decode(emission)

    supported = frame_valid & (emission > EMISSION_THRESHOLD)
    if fill:
        # grid fill (config enable_beat_grid_fill): keep every slot between
        # the first and last SUPPORTED beats — the tempo+phase lattice is
        # already fixed, and dropping unsupported interior slots only
        # punches holes in an otherwise-correct grid
        slot = jnp.arange(max_beats)
        first_sup = jnp.min(jnp.where(supported, slot[None, :], max_beats), axis=-1)
        last_sup = jnp.max(jnp.where(supported, slot[None, :], -1), axis=-1)
        is_beat = frame_valid & (slot[None, :] >= first_sup[:, None]) & (
            slot[None, :] <= last_sup[:, None]
        )
    else:
        is_beat = supported
    align = jnp.where(dist < TIMING_TOLERANCE_S, 1.0 - dist / TIMING_TOLERANCE_S, 0.0)
    conf = jnp.minimum(0.7 * emission + 0.3 * align, 1.0)

    beats = BeatTensor(
        times=jnp.where(is_beat, beat_times, 0.0),
        confidence=jnp.where(is_beat, conf, 0.0),
        valid=is_beat,
    )
    return beats, states
