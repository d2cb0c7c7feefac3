"""Sequential decoders of the beat grid (downbeat walk, Viterbi) vs plain
loop references."""

import numpy as np
import jax
import jax.numpy as jnp

from stratum_dsp_tpu.features.beat import hmm
from stratum_dsp_tpu.features.beat.grid import detect_downbeats


def test_downbeat_kernel_matches_scan(rng):
    b, n = 3, 64
    times = np.sort(rng.uniform(0, 30, (b, n)).astype(np.float32), axis=-1)
    n_beats = np.asarray([64, 40, 0], np.int32)
    bar = np.asarray([2.0, 1.5, 2.0], np.float32)
    # 4/4 (sig index 0): bar = 4 beats of 60/bpm seconds
    bpm = (4 * 60.0 / bar).astype(np.float32)

    got = np.asarray(jax.jit(detect_downbeats)(
        jnp.asarray(times), jnp.asarray(n_beats), jnp.asarray(bpm),
        jnp.zeros((b,), jnp.int32),
    ))

    for bi in range(b):
        last, any_db = 0.0, False
        ref = np.zeros(n, bool)
        for i in range(int(n_beats[bi])):
            t = times[bi, i]
            if not any_db:
                ref[i] = True
            elif abs(t - (last + bar[bi])) <= bar[bi] * 0.1:
                ref[i] = True
            if ref[i]:
                last, any_db = t, True
        np.testing.assert_array_equal(got[bi], ref)


def test_viterbi_kernel_matches_reference(rng):
    b, t = 2, 128
    em = rng.uniform(0.01, 1.0, (b, t)).astype(np.float32)
    got = np.asarray(jax.jit(hmm.viterbi_decode)(jnp.asarray(em)))

    trans = np.asarray(hmm.transition_matrix(), np.float32)
    for bi in range(b):
        v = np.full(5, 1 / 5, np.float32) * em[bi, 0]
        bps = np.zeros((t, 5), np.int64)
        for i in range(1, t):
            scores = v[:, None] * trans
            bps[i] = np.argmax(scores, axis=0)
            v = scores.max(axis=0).astype(np.float32) * em[bi, i]
        states = np.zeros(t, np.int64)
        states[-1] = np.argmax(v)
        for i in range(t - 1, 0, -1):
            states[i - 1] = bps[i][states[i]]
        np.testing.assert_array_equal(got[bi], states)


def test_viterbi_scan_eliminated_when_states_unused():
    """The pipeline discards the decoded states (grid.py unpacks
    ``beats, _states``), so XLA must drop both Viterbi scans: the compiled
    beats-only program has two fewer while loops than the one that returns
    the states."""
    b, k, mb = 2, 32, 64
    bpm = jnp.full((b,), 120.0)
    onsets = jnp.sort(jnp.linspace(0.0, 15.0, k))[None].repeat(b, 0)
    valid = jnp.ones((b, k), bool)

    def n_while(fn):
        hlo = jax.jit(fn).lower(bpm, onsets, valid).compile().as_text()
        return hlo.count(" while(")

    with_states = n_while(lambda *a: hmm.track_beats(*a, mb))
    beats_only = n_while(lambda *a: hmm.track_beats(*a, mb)[0])
    assert with_states - beats_only == 2, (with_states, beats_only)
