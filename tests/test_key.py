"""Key path: templates, scoring, detectors, end-to-end C-major fixture."""

import numpy as np
import jax.numpy as jnp

from stratum_dsp_tpu.config import AnalysisConfig, TemplateSet
from stratum_dsp_tpu.features.key import (
    detect_key_batch,
    detect_key_weighted,
    key_templates,
)
from stratum_dsp_tpu.features.key import scoring
from stratum_dsp_tpu.result import Key
from stratum_dsp_tpu.testing import SAMPLE_RATE, c_major_scale, pad_batch

CFG = AnalysisConfig()


def test_templates_shape_and_norm():
    for ts in TemplateSet:
        t = key_templates(ts)
        assert t.shape == (24, 12)
        np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-6)
    # rotation: G major template is C major rolled by 7
    t = key_templates(TemplateSet.KRUMHANSL_KESSLER)
    np.testing.assert_allclose(t[7], np.roll(t[0], 7), atol=1e-7)
    # minor row 12+9 = A minor: relative minor shares profile shape with C rotated
    np.testing.assert_allclose(t[12 + 9], np.roll(t[12], 9), atol=1e-7)


def synth_chroma(pitch_classes, n_frames=200, strength=1.0):
    ch = np.zeros((1, n_frames, 12), np.float32)
    for pc, w in pitch_classes:
        ch[:, :, pc] = w * strength
    n = np.linalg.norm(ch, axis=-1, keepdims=True)
    ch = ch / np.maximum(n, 1e-9)
    return jnp.asarray(ch)


def test_detect_c_major_triad():
    # C-E-G triad with tonic emphasis
    ch = synth_chroma([(0, 1.0), (4, 0.8), (7, 0.9)])
    mask = jnp.ones(ch.shape[:2], jnp.float32)
    res = detect_key_weighted(ch, None, mask, CFG)
    key = Key.from_index(int(res.key_idx[0]))
    assert key.name() == "C"
    # NOTE: single-call confidence is 0 by construction — the reference's
    # per-mode normalization ties the two mode maxima at exactly 1.2
    # (detector.rs:160-243); discrimination comes from segment voting.
    assert float(res.confidence[0]) >= 0.0
    assert float(res.clarity[0]) > 0.2


def test_detect_a_minor():
    # A-C-E triad (A minor) with strong minor third
    ch = synth_chroma([(9, 1.0), (0, 0.9), (4, 0.85)])
    mask = jnp.ones(ch.shape[:2], jnp.float32)
    res = detect_key_weighted(ch, None, mask, CFG)
    key = Key.from_index(int(res.key_idx[0]))
    # template matching may pick C major (relative) or A minor; both share
    # the pitch set — accept either but require the tonic in {A, C}
    assert key.name() in ("Am", "C")


def test_mode_heuristic_flip():
    # C minor spelled out: C, Eb, G plus minor 6th/7th cues
    ch = synth_chroma([(0, 1.0), (3, 0.9), (7, 0.9), (8, 0.4), (10, 0.4)])
    mask = jnp.ones(ch.shape[:2], jnp.float32)
    cfg = CFG.replace(enable_key_mode_heuristic=True, key_mode_flip_min_score_ratio=0.6)
    res = detect_key_weighted(ch, None, mask, cfg)
    key = Key.from_index(int(res.key_idx[0]))
    assert not key.is_major or key.tonic != 0  # must not report C major


def test_clarity_ordering():
    sharp = scoring.key_clarity(jnp.asarray([[1.0] + [0.1] * 23]))
    flat = scoring.key_clarity(jnp.asarray([[1.0] + [0.95] * 23]))
    assert float(sharp[0]) > float(flat[0])


def test_cmajor_scale_fixture_end_to_end():
    track = c_major_scale()
    samples, lengths = pad_batch([track])
    res = detect_key_batch(jnp.asarray(samples), jnp.asarray(lengths), CFG, SAMPLE_RATE)
    key = Key.from_index(int(res.key_idx[0]))
    assert key.name() == "C", f"got {key.name()}"
    # < 12 s of audio -> fewer frames than one segment-voting window -> the
    # full-track fallback, whose confidence is 0 by the tie construction
    assert float(res.confidence[0]) >= 0.0


def test_stable_argmax_breaks_dust_ties_to_first_index():
    """The best major and best minor key tie at EXACTLY 1.2 by construction
    (per-mode normalization + self-bonus), so the mode decision is the
    tie-break: first index (major) must win even when accumulation dust
    makes the minor side epsilon-larger (~2e-7 relative from f32
    accumulation order, enough to flip the C-major scale fixture to Am
    without scoring.stable_argmax)."""
    scores = np.full((1, 24), 0.5, np.float32)
    scores[0, 0] = 1.2          # C major
    scores[0, 21] = 1.2 + 2e-7  # A minor, epsilon above (accumulation dust)
    idx, conf = scoring.best_key_confidence(jnp.asarray(scores))
    assert int(idx[0]) == 0  # major wins the dust-tie
    # a REAL separation (> TIE_EPS) must still win outright
    scores[0, 21] = 1.2 + 5e-3
    idx, _ = scoring.best_key_confidence(jnp.asarray(scores))
    assert int(idx[0]) == 21


def test_short_track_default_key():
    samples = np.zeros((1, 4096), np.float32)
    res = detect_key_batch(jnp.asarray(samples), jnp.asarray([1000]), CFG, SAMPLE_RATE)
    assert int(res.key_idx[0]) == 0
    assert float(res.confidence[0]) == 0.0


def test_hpcp_approx_matches_exact():
    # The production HPCP path (approx_peaks=True) replaces exact top-k peak
    # selection + per-peak harmonic fan-out with a thresholded mask and ONE
    # matmul against the precomputed harmonic projection
    # (chroma.extractor.hpcp_harmonic_matrix). It must agree with the
    # reference-faithful exact path to near-f32 on realistic spectra, for
    # both static and traced per-track tuning offsets.
    from stratum_dsp_tpu.features.chroma import extractor as chx

    rng = np.random.default_rng(7)
    n_bins = 940
    spec = rng.random((2, 6, n_bins)).astype(np.float32) * 0.01
    for b in range(2):
        for t in range(6):
            for f0 in rng.integers(20, 200, size=5):
                for h in range(1, 4):
                    if f0 * h < n_bins:
                        spec[b, t, f0 * h] += rng.random() * (1.0 / h)
    spec = jnp.asarray(spec)
    kwargs = dict(
        sample_rate=SAMPLE_RATE, fft_size=8192, sigma=0.5,
        peaks_per_frame=24, num_harmonics=4, harmonic_decay=0.6,
        mag_power=0.5,
    )
    for tuning in (0.0, jnp.asarray([0.12, -0.3], jnp.float32)):
        exact = np.asarray(
            chx.frames_to_hpcp(spec, tuning_offset=tuning, approx_peaks=False, **kwargs)
        )
        fast = np.asarray(
            chx.frames_to_hpcp(spec, tuning_offset=tuning, approx_peaks=True, **kwargs)
        )
        assert np.abs(exact - fast).max() < 5e-3


def test_hpcp_per_track_tuning_is_per_track():
    # Regression: a [B] tuning vector must shift track b by offset[b] — not
    # broadcast against the trailing harmonic axis (latent round-1 bug,
    # masked by B == 1 in every prior test).
    from stratum_dsp_tpu.features.chroma import extractor as chx

    rng = np.random.default_rng(3)
    spec_row = rng.random((1, 6, 940)).astype(np.float32)
    spec = jnp.asarray(np.concatenate([spec_row, spec_row], axis=0))
    kwargs = dict(
        sample_rate=SAMPLE_RATE, fft_size=8192, sigma=0.5,
        peaks_per_frame=24, num_harmonics=4, harmonic_decay=0.6,
        mag_power=0.5,
    )
    for approx in (False, True):
        both = chx.frames_to_hpcp(
            spec, tuning_offset=jnp.asarray([0.0, 0.4]), approx_peaks=approx, **kwargs
        )
        solo0 = chx.frames_to_hpcp(
            spec[:1], tuning_offset=jnp.asarray([0.0]), approx_peaks=approx, **kwargs
        )
        solo1 = chx.frames_to_hpcp(
            spec[1:], tuning_offset=jnp.asarray([0.4]), approx_peaks=approx, **kwargs
        )
        np.testing.assert_allclose(np.asarray(both[0]), np.asarray(solo0[0]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(both[1]), np.asarray(solo1[0]), atol=1e-5)
        assert np.abs(np.asarray(both[0]) - np.asarray(both[1])).max() > 1e-3


def test_detect_key_changes_modulation():
    """Segment-wise key timeline (key_changes.rs:70-140): a chroma sequence
    that modulates C major -> G major mid-way must yield C segments then G
    segments, and a primary key from the majority."""
    import numpy as np
    import jax.numpy as jnp

    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.key.detector import detect_key_changes
    from stratum_dsp_tpu.features.key.templates import key_templates

    cfg = AnalysisConfig()
    frame_rate = 44100 / 512
    t = np.asarray(key_templates(cfg.key_template_set))
    f = int(frame_rate * 40)  # 40 s of frames
    half = f // 2
    chroma = np.zeros((1, f, 12), np.float32)
    chroma[0, :half] = t[0] / np.linalg.norm(t[0])   # C major profile
    chroma[0, half:] = t[7] / np.linalg.norm(t[7])   # G major profile
    mask = jnp.ones((1, f), jnp.float32)

    ts, key_idx, conf, seg_valid, primary = detect_key_changes(
        jnp.asarray(chroma), None, mask, jnp.asarray([f], jnp.int32),
        cfg, frame_rate,
    )
    ki = np.asarray(key_idx[0])
    sv = np.asarray(seg_valid[0])
    tstamps = np.asarray(ts)
    early = ki[sv & (tstamps + 8.0 < half / frame_rate)]
    late = ki[sv & (tstamps > half / frame_rate)]
    assert len(early) and (early == 0).all(), early   # C major
    assert len(late) and (late == 7).all(), late      # G major
    assert int(primary[0]) in (0, 7)


def test_tuning_estimation_parity_vs_numpy_port():
    """estimate_tuning_streamed (conditioning off, f32 path) vs the circular-
    mean port of extractor.rs:66-170 on a +5-cent detuned chord fixture
    (inside the +-0.08-semitone clamp). The repo's kept-bin stream starts at
    the 100 Hz band edge while the reference would also see 80-100 Hz; the
    numpy side uses the kept band so the comparison isolates the math."""
    import numpy as np
    import jax.numpy as jnp

    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.key import pipeline as kp
    from stratum_dsp_tpu.testing import numpy_ref as ref

    cfg = AnalysisConfig(
        enable_key_tuning_compensation=True,
        enable_key_harmonic_mask=False,
        enable_key_spectrogram_time_smoothing=False,
        stft_bf16=False,
    )
    # high-register tones: above ~900 Hz the 8192-point bin width is well
    # under a semitone, so bin-center residuals carry the detune signal
    # (low-register harmonics smear residuals by up to +-half a semitone,
    # which is why whole-mix detection is weak — matches the reference)
    t = np.arange(int(12.0 * 44100)) / 44100
    det = 2.0 ** (5.0 / 1200.0)
    x = sum(np.sin(2 * np.pi * f * det * t)
            for f in (987.77, 1174.66, 1318.51, 1567.98, 1760.0))
    x = (0.2 * x / np.abs(x).max()).astype(np.float32)
    got = float(kp.estimate_tuning_streamed(
        jnp.asarray(x[None]), jnp.asarray([len(x)], jnp.int32), cfg, 44100
    )[0])

    frame_size, _hop = kp._key_stft_params(cfg)
    keep = kp._key_keep_bins(cfg, 44100, frame_size)
    spec = ref.stft_magnitude(x.astype(np.float64), frame_size, 512)
    n_bins = keep if keep is not None else spec.shape[1]
    freq_res = 44100 / frame_size
    fmin = max(80.0, 0.0)
    want = ref.tuning_offset_np(
        spec[:, :n_bins], 44100, frame_size, fmin, 2000.0,
        cfg.key_tuning_frame_step, cfg.key_tuning_peak_rel_threshold,
    )
    want = float(np.clip(want, -cfg.key_tuning_max_abs_semitones,
                         cfg.key_tuning_max_abs_semitones))
    assert abs(got - want) < 0.005, (got, want)
    assert 0.025 < got < 0.08, got  # ~+0.05-semitone detune detected


def test_hpcp_parity_vs_numpy_port():
    """frames_to_hpcp (exact peak path) vs the literal port of the HPCP
    harmonic summation (extractor.rs:582-680) on scale-fixture frames."""
    import numpy as np
    import jax.numpy as jnp

    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.chroma.extractor import frames_to_hpcp
    from stratum_dsp_tpu.testing import numpy_ref as ref
    from stratum_dsp_tpu.testing import c_major_scale

    cfg = AnalysisConfig()
    frame_size = 8192
    spec = ref.stft_magnitude(c_major_scale().astype(np.float64), frame_size, 512)
    frames = spec[8:16].astype(np.float32)  # 8 frames mid-scale

    got = np.asarray(frames_to_hpcp(
        jnp.asarray(frames[None]), 44100, frame_size, cfg.soft_mapping_sigma,
        0.0, cfg.key_hpcp_peaks_per_frame, cfg.key_hpcp_num_harmonics,
        cfg.key_hpcp_harmonic_decay, cfg.key_hpcp_mag_power,
        approx_peaks=False,
    )[0])
    for i, frame in enumerate(frames):
        want = ref.frame_to_hpcp_np(
            frame, 44100, frame_size, cfg.soft_mapping_sigma, 0.0,
            cfg.key_hpcp_peaks_per_frame, cfg.key_hpcp_num_harmonics,
            cfg.key_hpcp_harmonic_decay, cfg.key_hpcp_mag_power,
        )
        err = np.linalg.norm(got[i] - want)
        assert err < 1e-3, (i, err, got[i], want)


def test_harmonic_mask_parity_vs_numpy_port():
    """harmonic_time_mask (the DEFAULT key conditioning) vs the port of
    extractor.rs:1246-1349, on interior frames away from chunk halos."""
    import numpy as np
    import jax.numpy as jnp

    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.chroma.extractor import harmonic_time_mask
    from stratum_dsp_tpu.testing import numpy_ref as ref

    cfg = AnalysisConfig()
    rng = np.random.default_rng(23)
    # sustained tones + transient spikes: both mask branches exercised
    spec = np.abs(rng.standard_normal((60, 40))).astype(np.float32) * 0.1
    spec[:, 7] += 2.0          # sustained harmonic line
    spec[20, :] += 5.0         # broadband transient
    spec[41, 12:20] += 3.0     # partial-band transient

    fvalid = jnp.ones((1, 60), bool)
    got = np.asarray(harmonic_time_mask(
        jnp.asarray(spec[None]), fvalid,
        cfg.key_spectrogram_smooth_margin, cfg.key_harmonic_mask_power,
    )[0])
    want = ref.harmonic_time_mask_np(
        spec, cfg.key_spectrogram_smooth_margin, cfg.key_harmonic_mask_power
    )
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 1e-5, err
    # the transient frame is strongly suppressed; the sustained line is not
    assert got[20, 3] < 0.5 * spec[20, 3]
    assert got[30, 7] > 0.8 * spec[30, 7]


def test_multi_scale_and_median_parity_vs_numpy_ports():
    """detect_key_multi_scale / detect_key_median vs the aggregation ports
    (detector.rs:546-700, 721-863) on structured chroma with a section
    change (so segment winners genuinely differ)."""
    import numpy as np
    import jax.numpy as jnp

    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.key import detector
    from stratum_dsp_tpu.features.key.templates import key_templates
    from stratum_dsp_tpu.testing import numpy_ref as ref

    rng = np.random.default_rng(31)
    t_np = ref.key_templates_np("kk")
    f = 480
    chroma = 0.15 * np.abs(rng.standard_normal((f, 12)))
    chroma[: f // 2] += 0.8 * t_np[2]    # D major section
    chroma[f // 2 :] += 0.8 * t_np[21]   # A minor section
    chroma = (chroma / np.linalg.norm(chroma, axis=1, keepdims=True)).astype(np.float32)
    weights = rng.random(f).astype(np.float32)

    cfg = AnalysisConfig(
        enable_key_multi_scale=True, key_multi_scale_lengths=(120, 240),
        key_multi_scale_hop=60,
    )
    jc = jnp.asarray(chroma[None])
    jw = jnp.asarray(weights[None])
    mask = jnp.ones((1, f), jnp.float32)
    n = jnp.asarray([f], jnp.int32)

    got_ms = detector.detect_key_multi_scale(jc, jw, mask, n, cfg)
    want_ms = ref.detect_key_multi_scale_np(
        chroma, weights, t_np, (120, 240), 60, cfg.key_multi_scale_min_clarity,
    )
    assert want_ms is not None
    assert int(got_ms.key_idx[0]) == want_ms[0]
    assert abs(float(got_ms.confidence[0]) - want_ms[1]) < 0.01

    cfg_md = AnalysisConfig(
        enable_key_median=True, enable_key_segment_voting=False,
        key_median_segment_length_frames=120, key_median_segment_hop_frames=60,
    )
    got_md = detector.detect_key_median(jc, jw, mask, n, cfg_md)
    want_md = ref.detect_key_median_np(chroma, weights, t_np, 120, 60,
                                       cfg_md.key_median_min_segments)
    assert want_md is not None
    assert int(got_md.key_idx[0]) == want_md[0]
    assert abs(float(got_md.confidence[0]) - want_md[1]) < 0.01


def test_whitening_and_logfreq_parity_vs_numpy_ports():
    """spectral_whiten and log_frequency_projection vs the literal ports
    (extractor.rs:556-580, 701-807)."""
    import numpy as np
    import jax.numpy as jnp

    from stratum_dsp_tpu.features.chroma.extractor import (
        log_frequency_projection, spectral_whiten,
    )
    from stratum_dsp_tpu.testing import numpy_ref as ref

    rng = np.random.default_rng(41)
    frame = (np.abs(rng.standard_normal(4097)) ** 2).astype(np.float32)
    frame[100] = 50.0  # a dominant narrowband peak

    got_w = np.asarray(spectral_whiten(jnp.asarray(frame[None, None]), 31)[0, 0])
    want_w = ref.spectral_whiten_np(frame, 31)
    assert np.linalg.norm(got_w - want_w) / np.linalg.norm(want_w) < 1e-5

    proj, bin_min = log_frequency_projection(44100, 8192, 100.0, 5000.0)
    got_lf = frame @ proj
    want_lf = ref.log_frequency_frame_np(frame, 44100, 8192, 100.0, 5000.0)
    assert got_lf.shape == want_lf.shape
    assert np.linalg.norm(got_lf - want_lf) / np.linalg.norm(want_lf) < 1e-5
