#!/usr/bin/env python
"""Attribute the pre-key pipeline (preproc/onsets/frontend/tempogram/legacy)
across its sub-stages. Scalar-only outputs keep the device-to-host copy out
of the numbers.

Usage: [B=8] [SECS=180] [REPS=3] python scripts/profile_front.py
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

    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.onset import detect_energy_flux_onsets
    from stratum_dsp_tpu.features.period import legacy as legacy_mod
    from stratum_dsp_tpu.features.period import novelty as nov
    from stratum_dsp_tpu.features.period import tempogram as tg
    from stratum_dsp_tpu.features.period import tempogram_fft as tft
    from stratum_dsp_tpu.preprocessing import normalization as norm
    from stratum_dsp_tpu.preprocessing import silence as sil
    from stratum_dsp_tpu.testing import kick_pattern_device

    b = int(os.environ.get("B", "8"))
    secs = float(os.environ.get("SECS", "180"))
    reps = int(os.environ.get("REPS", "3"))
    caps = PipelineCaps()
    cfg = AnalysisConfig()

    bpms = np.linspace(80.0, 175.0, b).astype(np.float32)
    sj = jax.jit(lambda x: kick_pattern_device(x, secs))(jax.device_put(bpms))
    jax.block_until_ready(sj)
    lj = jax.device_put(np.full((b,), int(secs * SR), np.int32))

    def scalar(tree):
        return sum(
            jnp.sum(x.astype(jnp.float32))
            for x in jax.tree_util.tree_leaves(tree)
            if hasattr(x, "astype")
        )

    def norm_only(s, l):
        out, _ = norm.normalize(s, l, cfg.normalization, SR,
                                target_loudness_lufs=-14.0, max_headroom_db=1.0)
        return scalar(jnp.sum(out * out, axis=-1))

    def silence_only(s, l):
        o_s, o_l, info = sil.detect_and_trim(s, l, SR, cfg.min_amplitude_db,
                                             frame_size=cfg.frame_size)
        return scalar(jnp.sum(o_s * o_s, axis=-1)) + scalar(o_l)

    def eflux_only(s, l):
        pos, val = detect_energy_flux_onsets(
            s, l, cfg.frame_size, cfg.hop_size, -20.0, caps.max_onsets)
        return scalar(jnp.sum(pos * val, axis=-1))

    def frontend_only(s, l):
        feats, fc, _ = nov.compute_bpm_spectral_features(
            s, l, cfg, SR, cfg.frame_size, cfg.hop_size,
            chunk_frames=caps.chunk_frames)
        return scalar(feats)

    def frontend_tempogram(s, l):
        feats, fc, _ = nov.compute_bpm_spectral_features(
            s, l, cfg, SR, cfg.frame_size, cfg.hop_size,
            chunk_frames=caps.chunk_frames)
        curves, nov_mask, n_valid = nov.assemble_novelty_curves(feats, fc, cfg)
        frame_rate = SR / cfg.hop_size
        fft_size = tft.padded_fft_size(curves["full"].shape[-1], frame_rate)
        variants = tg.compute_variants(curves, nov_mask, n_valid, frame_rate, cfg, fft_size)
        est = tg.estimate_bpm_tempogram(variants, cfg, frame_rate, fft_size, 10)
        return scalar(est["bpm"]) + scalar(est["confidence"])

    def legacy_only(s, l):
        pos, val = detect_energy_flux_onsets(
            s, l, cfg.frame_size, cfg.hop_size, -20.0, caps.max_onsets)
        est = legacy_mod.estimate_bpm_legacy(pos, val, s.shape[1], SR, cfg)
        return scalar(est["bpm"]) + scalar(est["confidence"])

    progs = {
        "normalize": norm_only,
        "silence": silence_only,
        "energy_onsets": eflux_only,
        "frontend_feats": frontend_only,
        "frontend+tempogram": frontend_tempogram,
        "eflux+legacy": legacy_only,
    }

    results = {}
    for name, f in progs.items():
        fn = jax.jit(f)
        r = fn(sj, lj)
        jax.block_until_ready(r)
        times = []
        for _ in range(reps):
            t0 = time.time()
            r = fn(sj, lj)
            float(np.asarray(r))
            times.append(time.time() - t0)
        med = float(np.median(times))
        results[name] = round(med * 1e3, 2)
        print(f"{name:20s} {med * 1e3:8.1f} ms  (all: {[round(t * 1e3, 1) for t in times]})",
              flush=True)

    print(json.dumps({"batch": b, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
