#!/usr/bin/env python
"""Micro-profile of the beat-grid stage on the real device.

Times track_beats / refine_beats / sig+downbeats+stability separately with
pipeline-representative shapes.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SR = 44100


def timeit(fn, *args, reps=5, label=""):
    from stratum_dsp_tpu import compile_cache
    compile_cache.enable()

    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    dt = (time.time() - t0) / reps
    print(f"{label:32s} {dt*1e3:9.3f} ms", flush=True)
    return out


def main():
    import jax
    import jax.numpy as jnp

    from stratum_dsp_tpu.features.beat import grid as gridmod
    from stratum_dsp_tpu.features.beat import hmm, variation
    from stratum_dsp_tpu.features.beat import time_signature as ts

    b = int(os.environ.get("B", "8"))
    max_onsets, max_beats, seg_cap, max_segs = 2048, 1024, 64, 48

    rng = np.random.default_rng(0)
    bpms = np.linspace(80.0, 175.0, b).astype(np.float32)
    onset_times = np.zeros((b, max_onsets), np.float32)
    onset_valid = np.zeros((b, max_onsets), bool)
    for i, bpm in enumerate(bpms):
        beat = 60.0 / bpm
        n = min(int(180.0 / beat), max_onsets)
        t = np.arange(n) * beat + rng.normal(0, 0.004, n)
        onset_times[i, :n] = np.sort(np.abs(t))
        onset_valid[i, :n] = True
    bpm_j = jnp.asarray(bpms)
    conf_j = jnp.full((b,), 0.5, jnp.float32)
    ot_j = jnp.asarray(onset_times)
    ov_j = jnp.asarray(onset_valid)

    track = jax.jit(lambda bb, t, v: hmm.track_beats(bb, t, v, max_beats))
    beats, states = timeit(track, bpm_j, ot_j, ov_j, label="hmm.track_beats")

    refine = jax.jit(
        lambda be, bb, cc, t, v: variation.refine_beats(be, bb, cc, t, v, seg_cap, max_segs)
    )
    refined, hasvar = timeit(refine, beats, bpm_j, conf_j, ot_j, ov_j, label="refine_beats")
    print("  has_variation:", np.asarray(hasvar))

    def tail(refined_t, refined_v, bb):
        btimes, n_beats = variation.compact_sorted(refined_t, refined_v)
        slot_valid = jnp.arange(btimes.shape[-1])[None, :] < n_beats[:, None]
        btimes = jnp.where(slot_valid, btimes, 0.0)
        sig, sig_conf = ts.detect_time_signature(btimes, slot_valid, n_beats)
        db = gridmod.detect_downbeats(btimes, n_beats, bb, sig)
        stab = gridmod.grid_stability(btimes, n_beats)
        return sig, db, stab

    tail_j = jax.jit(tail)
    timeit(tail_j, refined.times, refined.valid, bpm_j, label="compact+sig+downbeats+stab")

    # and the whole thing
    full = jax.jit(
        lambda bb, cc, t, v: gridmod.generate_beat_grid(bb, cc, t, v, max_beats, seg_cap, max_segs)
    )
    timeit(full, bpm_j, conf_j, ot_j, ov_j, label="generate_beat_grid (full)")

    # sub-pieces of the tail
    btimes, n_beats = variation.compact_sorted(refined.times, refined.valid)
    slot_valid = jnp.arange(btimes.shape[-1])[None, :] < n_beats[:, None]
    btimes = jnp.where(slot_valid, btimes, 0.0)
    sig, _ = ts.detect_time_signature(btimes, slot_valid, n_beats)
    timeit(jax.jit(lambda t, v, n: ts.detect_time_signature(t, v, n)), btimes, slot_valid, n_beats, label="  time_signature")
    timeit(jax.jit(lambda t, n, bb, s: gridmod.detect_downbeats(t, n, bb, s)), btimes, n_beats, bpm_j, sig, label="  downbeats")
    timeit(jax.jit(lambda t, v: variation.compact_sorted(t, v)), refined.times, refined.valid, label="  compact_sorted")

    em = jnp.asarray(rng.random((b, max_beats)), jnp.float32)
    timeit(jax.jit(hmm.viterbi_decode), em, label="  viterbi_decode")
    qt = jnp.asarray(rng.random((b, max_beats)) * 180.0, jnp.float32)
    timeit(jax.jit(lambda q, o, v: hmm.nearest_onset_distance(q, o, v)), qt, ot_j, ov_j, label="  nearest_onset_distance")


if __name__ == "__main__":
    main()
