#!/usr/bin/env python
"""Attribute detect_key_batch's device time across its sub-stages.

Every timed program returns ONLY scalar reductions (sums), so the
device-to-host copy stays out of the numbers.

Usage: [B=8] [SECS=180] [REPS=3] python scripts/profile_key.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SR = 44100


def main() -> int:
    from stratum_dsp_tpu import compile_cache

    compile_cache.enable()

    import jax
    import jax.numpy as jnp

    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.key import pipeline as kp
    from stratum_dsp_tpu.features.key.pipeline import (
        detect_key_batch,
        extract_key_features,
    )
    from stratum_dsp_tpu.ops.stft import stft_reduce
    from stratum_dsp_tpu.testing import kick_pattern_device

    b = int(os.environ.get("B", "8"))
    secs = float(os.environ.get("SECS", "180"))
    reps = int(os.environ.get("REPS", "3"))

    bpms = np.linspace(80.0, 175.0, b).astype(np.float32)
    sj = jax.jit(lambda x: kick_pattern_device(x, secs))(jax.device_put(bpms))
    jax.block_until_ready(sj)
    lj = jax.device_put(np.full((b,), int(secs * SR), np.int32))

    cfg = AnalysisConfig()
    frame_size, hop = kp._key_stft_params(cfg)
    keep_bins = kp._key_keep_bins(cfg, SR, frame_size)
    chunk = kp._auto_chunk(b, frame_size, 1024)

    def scalar(tree):
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree_util.tree_leaves(tree))

    # --- the timed programs -------------------------------------------------
    def full_key(s, l):
        return scalar(detect_key_batch(s, l, cfg, SR))

    def extract_only(s, l):
        return scalar(extract_key_features(s, l, cfg, SR))

    cfg_nohpcp = cfg.replace(enable_key_hpcp=False)

    def extract_plain_chroma(s, l):
        return scalar(extract_key_features(s, l, cfg_nohpcp, SR))

    cfg_nomask = cfg.replace(enable_key_harmonic_mask=False,
                             enable_key_spectrogram_time_smoothing=False)

    def extract_nomask(s, l):
        return scalar(extract_key_features(s, l, cfg_nomask, SR))

    def stft_energy_only(s, l):
        def reducer(spec, fidx, fvalid, carry):
            return {"e": jnp.sum(spec * spec, axis=-1)}, carry

        outs, _, _ = stft_reduce(
            s, l, frame_size, hop, reducer, lambda bb: jnp.zeros((bb,)),
            chunk_frames=chunk, halo=0, keep_bins=keep_bins, bf16=cfg.stft_bf16,
        )
        return scalar(outs)

    # STFT + harmonic mask, no chroma/HPCP
    halo = cfg.key_spectrogram_smooth_margin

    def stft_mask_only(s, l):
        def reducer(spec, fidx, fvalid, carry):
            cond = kp._condition_chunk(spec, fvalid, cfg, halo)
            c = spec.shape[1] - 2 * halo
            central = cond[:, halo : halo + c, :]
            return {"e": jnp.sum(central * central, axis=-1)}, carry

        outs, _, _ = stft_reduce(
            s, l, frame_size, hop, reducer, lambda bb: jnp.zeros((bb,)),
            chunk_frames=chunk, halo=halo, keep_bins=keep_bins, bf16=cfg.stft_bf16,
        )
        return scalar(outs)

    progs = {
        "stft_energy_only": stft_energy_only,
        "stft_plus_mask": stft_mask_only,
        "extract_nomask_hpcp": extract_nomask,
        "extract_plain_chroma": extract_plain_chroma,
        "extract_full": extract_only,
        "detect_key_full": full_key,
    }

    results = {}
    for name, f in progs.items():
        fn = jax.jit(f)
        r = fn(sj, lj)
        jax.block_until_ready(r)  # compile
        times = []
        for _ in range(reps):
            t0 = time.time()
            r = fn(sj, lj)
            float(np.asarray(r))
            times.append(time.time() - t0)
        med = float(np.median(times))
        results[name] = round(med * 1e3, 2)
        print(f"{name:24s} {med * 1e3:8.1f} ms  (all: {[round(t * 1e3, 1) for t in times]})",
              flush=True)

    print(json.dumps({"batch": b, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
