"""STFT frontend parity tests vs a naive per-frame reference implementation."""

import numpy as np
import jax.numpy as jnp

from stratum_dsp_tpu.ops import stft as stft_mod
from stratum_dsp_tpu.testing import kick_pattern, pad_batch


def naive_stft(x: np.ndarray, frame_size: int, hop: int) -> np.ndarray:
    """Reference semantics (chroma/extractor.rs:301-359): Hann with (n-1)
    denominator, rfft magnitude of the first frame_size/2+1 bins."""
    n = (len(x) - frame_size) // hop + 1
    i = np.arange(frame_size)
    w = 0.5 * (1.0 - np.cos(2 * np.pi * i / (frame_size - 1)))
    frames = np.stack([x[j * hop : j * hop + frame_size] * w for j in range(n)])
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


def collect_spec(samples, lengths, frame_size, hop, chunk_frames=64, bf16=False):
    """Materialize the streamed magnitudes for testing."""

    def reducer(spec, fidx, fvalid, carry):
        return {"spec": spec}, carry

    outs, nf_padded, frame_counts = stft_mod.stft_reduce(
        jnp.asarray(samples),
        jnp.asarray(lengths),
        frame_size,
        hop,
        reducer,
        lambda b: jnp.zeros((b,)),
        chunk_frames=chunk_frames,
        bf16=bf16,
    )
    return np.asarray(outs["spec"]), np.asarray(frame_counts)


def test_stft_matches_naive():
    x = kick_pattern(120.0, 3.0)
    y = kick_pattern(128.0, 2.0)
    samples, lengths = pad_batch([x, y])
    spec, counts = collect_spec(samples, lengths, 2048, 512)

    for b, trk in enumerate([x, y]):
        ref = naive_stft(trk, 2048, 512)
        assert counts[b] == ref.shape[0]
        got = spec[b, : counts[b]]
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        # padding frames are zeroed
        assert np.all(spec[b, counts[b] :] == 0.0)


def test_stft_hop_variants():
    x = kick_pattern(100.0, 2.0)
    samples, lengths = pad_batch([x])
    for frame, hop in [(2048, 256), (2048, 1024), (8192, 512)]:
        if len(x) < frame:
            continue
        spec, counts = collect_spec(samples, lengths, frame, hop, chunk_frames=32)
        ref = naive_stft(x, frame, hop)
        np.testing.assert_allclose(spec[0, : counts[0]], ref, rtol=3e-4, atol=3e-4)


def test_extract_frames_matches_gather():
    rng = np.random.default_rng(7)
    region = rng.standard_normal((2, 6 * 512 + 2048)).astype(np.float32)
    n_frames, frame, hop = 7, 2048, 512
    fast = np.asarray(stft_mod.extract_frames(jnp.asarray(region), n_frames, frame, hop))
    for j in range(n_frames):
        np.testing.assert_array_equal(fast[:, j], region[:, j * hop : j * hop + frame])


def test_polyphase_key_stft_energy_contract():
    """The bf16 polyphase key STFT (8192/512, 930 kept bins) vs a float64
    periodic-Hann rfft (its window; the symmetric-window gap is pinned by
    test_polyphase_stft_reduce_end_to_end): per-frame energy within 1% on
    every frame louder than -40 dB of the loudest frame, and max |err| within
    2% of the peak. Quieter frames are excluded: there the bf16 rounding of
    sidelobes that the 3-bin Hann mix cancels dominates the relative error."""
    x = kick_pattern(124.0, 6.0)
    samples, lengths = pad_batch([x])
    assert stft_mod.stft_path(8192, 512, True, 930) == "polyphase"

    def reducer(spec, fidx, fvalid, carry):
        return {"spec": spec}, carry

    o, _, counts = stft_mod.stft_reduce(
        jnp.asarray(samples), jnp.asarray(lengths), 8192, 512, reducer,
        lambda b: jnp.zeros((b,)), chunk_frames=64, keep_bins=930, bf16=True,
    )
    got = np.asarray(o["spec"])[0, : int(counts[0])].astype(np.float64)
    i = np.arange(8192)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * i / 8192)
    n = int(counts[0])
    frames = np.stack([x[j * 512 : j * 512 + 8192] * w for j in range(n)])
    ref = np.abs(np.fft.rfft(frames, axis=-1))[:, :930]
    assert np.abs(got - ref).max() / ref.max() < 2e-2
    e_ref, e_got = (ref**2).sum(-1), (got**2).sum(-1)
    loud = e_ref >= 1e-4 * e_ref.max()
    assert loud.mean() > 0.4
    np.testing.assert_allclose(e_got[loud], e_ref[loud], rtol=1e-2)


def test_bf16_pipeline_parity():
    # End-to-end: flipping stft_bf16 must not move any discrete decision
    # (BPM, key, beat count) and may only perturb continuous outputs at
    # far-below-tolerance levels. This is the contract config.stft_bf16
    # promises (see config.py docstring).
    import dataclasses

    from stratum_dsp_tpu.analysis import PipelineCaps, analyze_batch, decode_results
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.testing import SAMPLE_RATE, c_major_scale

    tracks = [kick_pattern(120.0, 8.0), c_major_scale()]
    samples, lengths = pad_batch(tracks)
    caps = PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=32, max_segments=12)

    results = {}
    for bf16 in (False, True):
        cfg = dataclasses.replace(AnalysisConfig(), stft_bf16=bf16)
        out = analyze_batch(samples, lengths, cfg, SAMPLE_RATE, caps)
        results[bf16] = decode_results(out, SAMPLE_RATE)

    for r32, rbf in zip(results[False], results[True]):
        assert abs(r32.bpm - rbf.bpm) < 0.5, (r32.bpm, rbf.bpm)
        assert r32.key.name() == rbf.key.name()
        beats32, beatsbf = r32.beat_grid.beats, rbf.beat_grid.beats
        assert abs(len(beats32) - len(beatsbf)) <= 1
        n = min(len(beats32), len(beatsbf))
        if n:
            assert np.abs(np.asarray(beats32[:n]) - np.asarray(beatsbf[:n])).max() < 0.05


def test_mel_filterbank_shape_and_coverage():
    w = stft_mod.mel_filterbank_matrix(44100, 1025, 40, 30.0, 8000.0)
    assert w.shape == (1025, 40)
    assert (w >= 0).all()
    # every filter has positive mass
    assert (w.sum(axis=0) > 0).all()
    # no energy above fmax bin (generous slack for rounding)
    fmax_bin = int(round(8000.0 / (44100 / 2048))) + 2
    assert w[fmax_bin + 1 :, :].sum() == 0


def test_polyphase_matches_periodic_hann_dft():
    """The polyphase shared-block path (the bf16 key STFT) must reproduce the
    periodic-Hann windowed DFT exactly in f32, including non-R-aligned ext,
    a region that does not start at the track start, and the 3-bin mix edge
    bins."""
    import jax

    rng = np.random.default_rng(3)
    B, N, H, KB = 2, 2048, 128, 300  # R = 16
    ext, start = 53, 37  # any region start, any ext
    need = (start + stft_mod.poly_num_blocks(ext, N, H) + 1) * H
    x = rng.standard_normal((B, need)).astype(np.float32)

    mag = np.asarray(
        jax.jit(
            lambda s: stft_mod.polyphase_chunk_magnitudes(
                s[:, start * H :], ext, N, H, KB, bf16=False
            )
        )(jnp.asarray(x))
    )

    i = np.arange(N)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * i / N)  # periodic Hann
    ref = np.zeros((B, ext, KB))
    for f in range(ext):
        fr = x[:, (start + f) * H : (start + f) * H + N].astype(np.float64) * w
        ref[:, f] = np.abs(np.fft.rfft(fr, axis=-1)[:, :KB])

    scale = np.abs(ref).max()
    assert np.abs(mag - ref).max() < 2e-3 * max(scale, 1.0)


def test_polyphase_stft_reduce_end_to_end():
    """stft_reduce on the bf16 polyphase path (multi-chunk + per-track
    lengths) vs the f32 symmetric-Hann rfft path: magnitudes agree to the
    periodic-vs-symmetric Hann O(1/N) bound, frame validity masks identical."""
    x = kick_pattern(123.0, 4.0)
    y = kick_pattern(97.0, 3.0)
    samples, lengths = pad_batch([x, y])
    frame, hop = 8192, 512

    spec_p, counts_p = collect_spec(samples, lengths, frame, hop, chunk_frames=48, bf16=True)
    spec_d, counts_d = collect_spec(samples, lengths, frame, hop, chunk_frames=48)

    np.testing.assert_array_equal(counts_p, counts_d)
    assert spec_p.shape[1] >= counts_p.max()
    for b in range(2):
        got = spec_p[b, : counts_p[b]]
        ref = spec_d[b, : counts_d[b]]
        # periodic vs symmetric (n-1) Hann differs by O(1/N) per sample
        assert np.abs(got - ref).max() < 2e-2 * max(ref.max(), 1.0)
        assert np.all(spec_p[b, counts_p[b] :] == 0.0)
