"""Time-block sharded spectral frontend == single-device frontend."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from stratum_dsp_tpu.config import AnalysisConfig
from stratum_dsp_tpu.features.period import novelty as nov
from stratum_dsp_tpu.parallel.timeblocks import compute_bpm_spectral_features_sharded
from stratum_dsp_tpu.testing import SAMPLE_RATE, kick_pattern, pad_batch

CFG = AnalysisConfig()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_features_match_unsharded():
    frame, hop = CFG.frame_size, CFG.hop_size
    n_time = 4
    tracks = [kick_pattern(120.0, 3.0), kick_pattern(132.0, 2.4)]
    # pad to a multiple of n_time*hop
    t = max(len(x) for x in tracks)
    t = ((t + n_time * hop - 1) // (n_time * hop)) * (n_time * hop)
    samples, lengths = pad_batch(tracks, pad_to=t)

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("tracks", "time"))
    feats_sh, fc_sh, _ = compute_bpm_spectral_features_sharded(
        jnp.asarray(samples), jnp.asarray(lengths), CFG, SAMPLE_RATE, frame, hop, mesh
    )
    feats_ref, fc_ref, _ = nov.compute_bpm_spectral_features(
        jnp.asarray(samples), jnp.asarray(lengths), CFG, SAMPLE_RATE, frame, hop
    )
    np.testing.assert_array_equal(np.asarray(fc_sh), np.asarray(fc_ref))

    for name in ("superflux", "energy", "hfc", "onset_sflux", "mel"):
        if name not in feats_ref:
            continue
        a = np.asarray(feats_sh[name])
        b = np.asarray(feats_ref[name])
        nf = min(a.shape[1], b.shape[1])
        # compare only valid frames per track
        for bi in range(len(tracks)):
            n = int(fc_ref[bi])
            np.testing.assert_allclose(
                a[bi, :n], b[bi, :n], rtol=2e-4, atol=2e-4,
                err_msg=f"{name} mismatch (track {bi})",
            )


def test_full_pipeline_2d_mesh_matches_unsharded():
    """Full default pipeline on a (tracks, time) mesh == unsharded results;
    the ahead-of-time form runs the same program."""
    import jax
    from jax.sharding import Mesh
    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps, analyze_batch_arrays
    from stratum_dsp_tpu.parallel.mesh import (
        analyze_batch_sharded, compile_sharded, make_mesh, pad_batch_for_mesh,
    )
    from stratum_dsp_tpu.testing import kick_pattern, pad_batch

    cfg = AnalysisConfig()
    caps = PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=16, max_segments=6)
    tracks = [kick_pattern(74.0, 6.0), kick_pattern(132.0, 6.0),
              kick_pattern(101.0, 5.0), kick_pattern(156.0, 6.0)]
    samples, lengths = pad_batch(tracks)

    mesh = make_mesh(jax.devices()[:8], n_time=2)  # 4 tracks x 2 time blocks
    samples_p = pad_batch_for_mesh(samples, mesh)
    out_sh = analyze_batch_sharded(samples_p, lengths, cfg, 44100, caps, mesh)
    out_ref = jax.jit(
        analyze_batch_arrays, static_argnames=("cfg", "sample_rate", "caps")
    )(jnp.asarray(samples_p), jnp.asarray(lengths), cfg=cfg, sample_rate=44100, caps=caps)
    compiled, args = compile_sharded(samples_p, lengths, cfg, 44100, caps, mesh)
    out_aot = compiled(*args)

    for k in ("bpm", "bpm_confidence", "key_idx", "key_confidence",
              "grid_stability", "ok", "multi_res_used"):
        ref, got = np.asarray(out_ref[k]), np.asarray(out_sh[k])
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_array_equal(np.asarray(out_aot[k]), got, err_msg=k)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_full_pipeline_1d_mesh_shard_local_escalation_matches_unsharded():
    """1-D tracks mesh == unsharded, WITH the shard-local escalation tiers.

    16 tracks over 8 shards (2 per shard) with trap-zone seeds on some
    shards: each device independently picks its own lax.switch tier
    (skip / sub-1 / full-2), which must not change any per-track result
    vs the unsharded tiered path (round-4 verdict item 4: pods keep the
    sub-batched escalation economics)."""
    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps, analyze_batch_arrays
    from stratum_dsp_tpu.parallel.mesh import analyze_batch_sharded, make_mesh

    cfg = AnalysisConfig()
    caps = PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=16, max_segments=6)
    # trap-zone (75/172/78) and clean seeds interleaved so some shards
    # escalate 0, some 1, some 2 of their 2 tracks
    bpms = [75.0, 120.0, 128.0, 172.0, 78.0, 174.0, 101.0, 132.0,
            140.0, 76.0, 96.0, 108.0, 176.0, 116.0, 88.0, 124.0]
    tracks = [kick_pattern(x, 6.0) for x in bpms]
    samples, lengths = pad_batch(tracks)

    mesh = make_mesh(jax.devices()[:8])  # 1-D tracks mesh, bl = 2
    out_sh = analyze_batch_sharded(samples, lengths, cfg, 44100, caps, mesh)
    out_ref = jax.jit(
        analyze_batch_arrays, static_argnames=("cfg", "sample_rate", "caps")
    )(jnp.asarray(samples), jnp.asarray(lengths), cfg=cfg, sample_rate=44100,
      caps=caps)

    assert np.asarray(out_ref["multi_res_triggered"]).any()
    for k in ("bpm", "bpm_confidence", "key_idx", "key_confidence",
              "grid_stability", "ok", "multi_res_used", "multi_res_triggered"):
        ref, got = np.asarray(out_ref[k]), np.asarray(out_sh[k])
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=k)
