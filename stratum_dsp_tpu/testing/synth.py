"""Synthetic test-signal generators.

Deterministic numpy generators with the same signal characteristics as the
reference's fixture set (``scripts/generate_fixtures.py:29-151``): exp-decay
kick trains at exact BPMs (60 Hz fundamental + 120/180 Hz harmonics), a
C-major scale of faded sine notes, and a silence/tone/silence sandwich.
Shared by unit tests, the validation harness, and ``bench.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SAMPLE_RATE = 44100


def kick_pattern(
    bpm: float,
    duration_s: float,
    sample_rate: int = SAMPLE_RATE,
    kick_ms: float = 100.0,
    decay: float = 10.0,
    fundamental_hz: float = 60.0,
) -> np.ndarray:
    """Kick-drum train at ``bpm``: decaying sine stack at each beat time."""
    n = int(duration_s * sample_rate)
    out = np.zeros(n, dtype=np.float64)
    kick_n = int(kick_ms / 1000.0 * sample_rate)
    t = np.arange(kick_n) / sample_rate
    kick = (
        0.6 * np.sin(2 * np.pi * fundamental_hz * t)
        + 0.3 * np.sin(2 * np.pi * 2 * fundamental_hz * t)
        + 0.1 * np.sin(2 * np.pi * 3 * fundamental_hz * t)
    ) * np.exp(-decay * t)
    beat_interval = 60.0 / bpm
    for beat_time in np.arange(0.0, duration_s, beat_interval):
        s = int(beat_time * sample_rate)
        e = min(s + kick_n, n)
        out[s:e] += kick[: e - s]
    peak = np.abs(out).max()
    if peak > 0:
        out /= peak
    return out.astype(np.float32)


C_MAJOR_FREQS = (261.63, 293.66, 329.63, 349.23, 392.00, 440.00, 493.88, 523.25)


def c_major_scale(
    note_s: float = 0.5, sample_rate: int = SAMPLE_RATE, fade_ms: float = 50.0
) -> np.ndarray:
    """C-major scale (C4..C5), each note a faded sine."""
    notes = []
    fade_n = int(fade_ms / 1000.0 * sample_rate)
    for f in C_MAJOR_FREQS:
        nn = int(note_s * sample_rate)
        t = np.arange(nn) / sample_rate
        note = np.sin(2 * np.pi * f * t)
        env = np.ones(nn)
        env[:fade_n] = np.linspace(0.0, 1.0, fade_n)
        env[-fade_n:] = np.linspace(1.0, 0.0, fade_n)
        notes.append(note * env)
    out = np.concatenate(notes)
    return (out / np.abs(out).max()).astype(np.float32)


def silence_sandwich(
    silence_s: float = 5.0,
    audio_s: float = 5.0,
    sample_rate: int = SAMPLE_RATE,
    tone_hz: float = 440.0,
    amplitude: float = 0.5,
) -> np.ndarray:
    """silence | tone | silence — for silence-trim tests."""
    sil = np.zeros(int(silence_s * sample_rate), dtype=np.float32)
    t = np.arange(int(audio_s * sample_rate)) / sample_rate
    tone = (amplitude * np.sin(2 * np.pi * tone_hz * t)).astype(np.float32)
    return np.concatenate([sil, tone, sil])


def click_track(
    bpm: float, duration_s: float, sample_rate: int = SAMPLE_RATE, click_ms: float = 5.0
) -> np.ndarray:
    """Sharp broadband clicks at the beat grid (for onset/beat tests)."""
    n = int(duration_s * sample_rate)
    out = np.zeros(n, dtype=np.float32)
    click_n = max(int(click_ms / 1000.0 * sample_rate), 1)
    rng = np.random.default_rng(1234)
    click = (rng.standard_normal(click_n) * np.exp(-np.arange(click_n) / (click_n / 4))).astype(
        np.float32
    )
    beat_interval = 60.0 / bpm
    for beat_time in np.arange(0.0, duration_s, beat_interval):
        s = int(beat_time * sample_rate)
        e = min(s + click_n, n)
        out[s:e] += click[: e - s]
    peak = np.abs(out).max()
    return (out / peak).astype(np.float32) if peak > 0 else out


def pad_batch(tracks: Sequence[np.ndarray], pad_to: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length mono tracks into a padded ``[B, T]`` batch.

    Returns (samples, lengths). ``pad_to`` overrides the max length (must be
    >= every track).
    """
    lengths = np.asarray([len(t) for t in tracks], dtype=np.int32)
    t_max = int(pad_to if pad_to is not None else lengths.max())
    if (lengths > t_max).any():
        raise ValueError("pad_to shorter than longest track")
    out = np.zeros((len(tracks), t_max), dtype=np.float32)
    for i, trk in enumerate(tracks):
        out[i, : len(trk)] = trk
    return out, lengths


def kick_pattern_device(bpms, duration_s: float, sample_rate: int = SAMPLE_RATE,
                        kick_ms: float = 100.0, decay: float = 10.0,
                        fundamental_hz: float = 60.0):
    """Device-side batched kick trains: ``bpms [B]`` -> ``[B, T]`` float32.

    Same signal family as :func:`kick_pattern` in closed form (kicks never
    overlap for bpm <= 240, so sample i is the kick waveform evaluated at
    ``t mod beat_interval``). Synthesizing a [40, 7.9M] bench batch on the
    device keeps benchmark set-up off the host and the host-to-device copy.
    """
    import jax.numpy as jnp

    n = int(duration_s * sample_rate)
    bpms = jnp.asarray(bpms, jnp.float32)
    t = jnp.arange(n, dtype=jnp.float32) / sample_rate  # [T]
    interval = 60.0 / bpms[:, None]  # [B, 1]
    ts = jnp.mod(t[None, :], interval)  # time since last beat
    w = 2.0 * jnp.pi * fundamental_hz * ts
    kick = (0.6 * jnp.sin(w) + 0.3 * jnp.sin(2 * w) + 0.1 * jnp.sin(3 * w)) * jnp.exp(
        -decay * ts
    )
    out = jnp.where(ts < kick_ms / 1000.0, kick, 0.0)
    peak = jnp.max(jnp.abs(out), axis=-1, keepdims=True)
    return (out / jnp.maximum(peak, 1e-9)).astype(jnp.float32)
