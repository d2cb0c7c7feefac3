"""Batched, chunked STFT frontend.

Batched replacement for the reference's ``compute_stft``
(``chroma/extractor.rs:301-359``): Hann window with ``(n-1)`` denominator,
forward rFFT, magnitude of the first ``frame_size/2 + 1`` bins, frame count
``(len - frame_size)/hop + 1``.

Design notes:

* Tracks are batched ``[B, T]`` with per-track ``lengths``; all shapes static.
* A full 3-minute spectrogram (15k x 1025..4097 f32) does not need to live in
  HBM: downstream consumers are per-frame *reductions* (novelty curves, band
  energies, chroma). We therefore scan over **frame chunks**: each scan step
  materializes only ``[B, chunk, K]`` magnitudes, applies a caller-provided
  reducer, and emits small per-frame features. This keeps device-memory
  traffic at the streaming minimum and lets XLA pipeline FFT + reduction.
* One function, :func:`chunk_magnitudes`, computes a chunk's magnitudes for
  every caller (``stft_reduce`` and the time-sharded
  ``parallel.timeblocks.stft_reduce_sharded``). It takes the polyphase
  shared-block path for the bf16 key STFT (8192/512) and ``jnp.fft.rfft``
  (cuFFT on the GPU) for everything else; both beat a DFT matmul on the
  H100 (PERF.md).
* Frame extraction uses the ``frame_size % hop == 0`` layout trick: reshape
  the sample region into hop-sized blocks and concatenate ``frame//hop``
  *statically shifted* block slices — zero gathers, pure reshapes.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def num_frames(n_samples: int, frame_size: int, hop: int) -> int:
    """Frame count for a signal of length n (extractor.rs:314)."""
    if n_samples < frame_size:
        return 0
    return (n_samples - frame_size) // hop + 1


def hann_window(frame_size: int, dtype=jnp.float32) -> jax.Array:
    """Hann window with the reference's (n-1) denominator (extractor.rs:318-323)."""
    i = np.arange(frame_size, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / (frame_size - 1)))
    return jnp.asarray(w, dtype=dtype)


def extract_frames(region: jax.Array, n_frames: int, frame_size: int, hop: int) -> jax.Array:
    """Extract overlapping frames from ``region [B, L]`` where
    ``L >= (n_frames-1)*hop + frame_size``. Returns ``[B, n_frames, frame_size]``.

    Fast path requires ``frame_size % hop == 0`` (true for every config the
    pipeline uses: 2048/512, 2048/256, 2048/1024, 8192/512).
    """
    b = region.shape[0]
    if frame_size % hop == 0:
        k = frame_size // hop
        n_blocks = n_frames + k - 1
        need = n_blocks * hop
        region = region[:, :need]
        blocks = region.reshape(b, n_blocks, hop)
        parts = [blocks[:, j : j + n_frames, :] for j in range(k)]
        return jnp.concatenate(parts, axis=-1)
    # general gather fallback
    idx = jnp.arange(n_frames)[:, None] * hop + jnp.arange(frame_size)[None, :]
    return region[:, idx]


def rfft_magnitudes(frames: jax.Array, keep_bins=None) -> jax.Array:
    """|rfft| of symmetric-Hann-windowed frames ``[B, C, F]`` ->
    ``[B, C, keep_bins or F//2+1]`` float32."""
    spec = jnp.fft.rfft(frames * hann_window(frames.shape[-1], frames.dtype), axis=-1)
    if keep_bins is not None:
        spec = spec[..., :keep_bins]
    return jnp.abs(spec).astype(jnp.float32)


# --------------------------------------------------------------------------
# Polyphase shared-block STFT (the bf16 path for the high-overlap key STFT)
# --------------------------------------------------------------------------
#
# At frame/hop ratio R = 16 (the 8192/512 key STFT) consecutive frames share
# all but one hop-block of samples. Computing the DFT of each hop-block ONCE
# and combining R of them cuts the work ~R x vs a per-frame transform:
#
#   X_f[k] = sum_m e^{-2pi i k m/R} * Bd[f+m, k]
#   Bd[j, k] = sum_s x[j*hop + s] * e^{-2pi i k s/N}   (one [hop, 2K] matmul)
#
# The tap phases are pure frame-offset phases, so with the per-block twiddle
# C[j, k] = e^{-2pi i k j/R} Bd[j, k] the combine collapses to
#
#   X_f[k] = e^{+2pi i k f/R} * S_f[k],   S_f[k] = sum_{j=f}^{f+R-1} C[j, k]
#
# i.e. a width-R BOX SUM along frames — which runs as a banded 0/1 matmul
# (the same pattern as chroma.extractor.windowed_time_mean; a frame-axis
# cumsum costs O(log T) passes over the stream).
#
# Windowing uses the *periodic* Hann identity: with w[n] = 0.5 - 0.5
# cos(2pi n/N) the windowed spectrum is exactly 0.5 X[k] - 0.25 X[k-1]
# - 0.25 X[k+1] (X[-1] = conj X[1] for real input). The reference's
# symmetric (n-1) Hann differs from the periodic one by O(1/N) per window
# sample — far below the bf16 path's ~0.4% rounding contract (test_stft.py
# pins decision parity) — so the polyphase path is enabled only when
# ``bf16`` is on; the f32 parity path keeps the symmetric-Hann rfft. The
# untwiddle phase e^{+2pi i k f/R} is folded into the 3-bin mix, where the
# magnitude kills the k-dependent outer factor and leaves only per-frame
# scalars e^{-+2pi i f/R} on the k-+1 terms:
#
#   |Xw[f,k]| = |0.5 S[k] - 0.25 (e^{-i phi} S[k-1] + e^{+i phi} S[k+1])|,
#   phi = 2pi f / R,  S[-1] = conj S[1].

POLY_FT = 128  # frames per box-sum tile (band waste = (FT+R)/R per matmul)


def _poly_block_basis(n: int, hop: int, kp: int, bf16: bool) -> jax.Array:
    """[hop, 2*KP] unwindowed DFT basis on the N-point grid restricted to a
    hop-block's support (device iota build, exact int phase)."""
    s = jax.lax.broadcasted_iota(jnp.int32, (hop, kp), 0)
    k = jax.lax.broadcasted_iota(jnp.int32, (hop, kp), 1)
    phase = ((s * k) % n).astype(jnp.float32) * (2.0 * np.pi / n)
    basis = jnp.concatenate([jnp.cos(phase), -jnp.sin(phase)], axis=1)
    return basis.astype(jnp.bfloat16) if bf16 else basis


def _poly_twiddle_table(r: int, kp: int) -> tuple:
    """Constant ``[r, kp]`` twiddle e^{-2pi i k t/R} for block class t = j%R
    (block j counted from the region start). Broadcast-multiplied over
    ``[B, eb/R, R, kp]`` — no per-chunk trig, no gather."""
    t = jax.lax.broadcasted_iota(jnp.int32, (r, kp), 0)
    k = jax.lax.broadcasted_iota(jnp.int32, (r, kp), 1)
    ang = ((t * (k % r)) % r).astype(jnp.float32) * (2.0 * np.pi / r)
    return jnp.cos(ang), -jnp.sin(ang)


def poly_num_blocks(ext: int, frame_size: int, hop: int) -> int:
    """Blocks a polyphase chunk of ``ext`` frames consumes. Rounded up to a
    multiple of R for the class-grouped stage-1 reshape."""
    r = frame_size // hop
    return -(-(ext + r) // r) * r


def polyphase_chunk_magnitudes(
    region: jax.Array,
    ext: int,
    frame_size: int,
    hop: int,
    keep_bins: int,
    bf16: bool = True,
) -> jax.Array:
    """Periodic-Hann STFT magnitudes of the ``ext`` frames starting at sample
    0 of ``region [B, L]`` via the polyphase shared-block path; returns
    ``[B, ext, keep_bins]``. ``L >= poly_num_blocks(ext) * hop``; samples past
    the last frame only feed discarded frames. Counting blocks and frames
    from the region start makes every block's twiddle class and every
    frame's mix phase a compile-time constant."""
    b = region.shape[0]
    r = frame_size // hop
    kp = -(-(keep_bins + 1) // 128) * 128  # bin keep_bins feeds the k+1 mix
    ebp = poly_num_blocks(ext, frame_size, hop)

    # stage 1: per-block DFT, ONE well-shaped matmul (fragmenting it by
    # twiddle class leaves ~eb/R rows per product)
    blocks = region[:, : ebp * hop].reshape(b, ebp, hop)
    basis = _poly_block_basis(frame_size, hop, kp, bf16)
    if bf16:
        blocks = blocks.astype(jnp.bfloat16)
    bd = jnp.matmul(blocks, basis, preferred_element_type=jnp.float32)

    # per-block twiddle C = e^{-2pi i k j/R} * Bd. The class pattern j % R
    # is static: one broadcast multiply by a constant
    # [R, kp] table (no trig, no gather — XLA folds the table).
    twre, twim = _poly_twiddle_table(r, kp)
    bre = bd[..., :kp].reshape(b, ebp // r, r, kp)
    bim = bd[..., kp:].reshape(b, ebp // r, r, kp)
    c = jnp.concatenate(
        [bre * twre - bim * twim, bre * twim + bim * twre], axis=-1
    ).reshape(b, ebp, 2 * kp)
    eb = ebp
    if bf16:
        c = c.astype(jnp.bfloat16)  # halves box-sum reads; f32 accumulate

    # width-R box sum along frames as banded matmuls over FT-frame tiles:
    # S[f] = W1 @ cur_tile + W2 @ next_tile (the band crosses one tile edge)
    ft = POLY_FT
    nt = -(-ext // ft)
    pad_rows = nt * ft + ft - eb
    cpad = jnp.pad(c, ((0, 0), (0, pad_rows), (0, 0)))
    cur = cpad[:, : nt * ft].reshape(b, nt, ft, 2 * kp)
    nxt = cpad[:, ft : (nt + 1) * ft].reshape(b, nt, ft, 2 * kp)
    f_i = jax.lax.broadcasted_iota(jnp.int32, (ft, ft), 0)
    e_i = jax.lax.broadcasted_iota(jnp.int32, (ft, ft), 1)
    w1 = ((e_i >= f_i) & (e_i < f_i + r)).astype(c.dtype)
    w2 = (e_i + ft < f_i + r).astype(c.dtype)
    s = jnp.einsum(
        "fe,bjek->bjfk", w1, cur, preferred_element_type=jnp.float32
    ) + jnp.einsum(
        "fe,bjek->bjfk", w2, nxt, preferred_element_type=jnp.float32
    )
    if bf16:
        # The mix below re-reads s at three bin offsets; storing it bf16
        # (f32 accumulation happened inside the einsums) halves the largest
        # memory stream of the polyphase path. Rounding is ~2^-9 of local
        # |S|; where the 3-bin mix cancels (sidelobes), the RELATIVE error of
        # the mixed output can be much larger than 2^-9 — acceptable only
        # because downstream consumers (harmonic mask, HPCP) are driven by
        # spectral peaks, where the mix does not cancel. Decision parity is
        # pinned by test_stft.py and re-checked on the GPU by chip_smoke.py.
        s = s.astype(jnp.bfloat16)
    s = s.reshape(b, nt * ft, 2 * kp)[:, :ext]
    sre, sim = s[..., :kp], s[..., kp:]

    # periodic-Hann 3-bin mix with the untwiddle folded in (see header);
    # S[-1] = conj S[1]; the top kp-keep_bins >= 1 spare bins absorb k+1.
    # Frames count from the region start: the phase is an arange pattern.
    phi = ((jnp.arange(ext) % r).astype(jnp.float32) * (2.0 * np.pi / r))[
        None, :, None
    ]
    cphi, sphi = jnp.cos(phi), jnp.sin(phi)
    m1re = jnp.concatenate([sre[..., 1:2], sre[..., :-1]], axis=-1)
    m1im = jnp.concatenate([-sim[..., 1:2], sim[..., :-1]], axis=-1)
    p1re = jnp.concatenate([sre[..., 1:], sre[..., -1:]], axis=-1)
    p1im = jnp.concatenate([sim[..., 1:], sim[..., -1:]], axis=-1)
    wre = 0.5 * sre - 0.25 * (
        (m1re + p1re) * cphi + (m1im - p1im) * sphi
    )
    wim = 0.5 * sim - 0.25 * (
        (m1im + p1im) * cphi + (p1re - m1re) * sphi
    )
    mag = jnp.sqrt(wre * wre + wim * wim)
    return mag[..., :keep_bins]


def use_polyphase(frame_size: int, hop: int, bf16: bool, keep_bins=None) -> bool:
    """The polyphase path pays off when >=16 frames share each block (the
    8192/512 key STFT; at R=8, the 2048/256 multi-res pass, the twiddle/mix
    work outweighs the saving). It is part of the bf16 contract (periodic vs
    symmetric Hann)."""
    if not bf16 or frame_size % hop or hop % 128 or (frame_size // hop) < 16:
        return False
    kb = frame_size // 2 + 1 if keep_bins is None else keep_bins
    return -(-(kb + 1) // 128) * 128 <= frame_size


def stft_path(frame_size: int, hop: int, bf16: bool, keep_bins=None) -> str:
    """Which magnitude formulation :func:`chunk_magnitudes` takes:
    ``"polyphase"`` or ``"rfft"``."""
    return "polyphase" if use_polyphase(frame_size, hop, bf16, keep_bins) else "rfft"


def region_len(ext: int, frame_size: int, hop: int, bf16: bool, keep_bins=None) -> int:
    """Samples :func:`chunk_magnitudes` reads for a chunk of ``ext`` frames."""
    if use_polyphase(frame_size, hop, bf16, keep_bins):
        return poly_num_blocks(ext, frame_size, hop) * hop
    return (ext - 1) * hop + frame_size


def chunk_magnitudes(
    region: jax.Array, ext: int, frame_size: int, hop: int, keep_bins=None,
    bf16: bool = False,
) -> jax.Array:
    """Magnitudes ``[B, ext, K]`` float32 of the ``ext`` frames starting at
    sample 0 of ``region [B, >= region_len(...)]``."""
    if use_polyphase(frame_size, hop, bf16, keep_bins):
        return polyphase_chunk_magnitudes(
            region, ext, frame_size, hop, keep_bins or frame_size // 2 + 1
        )
    return rfft_magnitudes(extract_frames(region, ext, frame_size, hop), keep_bins)


def stft_reduce(
    samples: jax.Array,
    lengths: jax.Array,
    frame_size: int,
    hop: int,
    reducer: Callable,
    carry_init: Callable,
    chunk_frames: int = 256,
    halo: int = 0,
    keep_bins=None,
    bf16: bool = False,
):
    """Scan the batched STFT in frame chunks and reduce each chunk.

    Args:
      samples: ``[B, T]`` padded sample batch (padding must be zeros).
      lengths: ``[B]`` int32 valid sample counts.
      frame_size, hop: STFT params.
      reducer: ``(spec, frame_idx, frame_valid, carry) -> (outs, carry)`` where
        ``spec`` is ``[B, C + halo_frames, K]`` magnitudes covering frames
        ``[chunk_start - halo, chunk_start + C + halo)`` clamped to the global
        frame range (out-of-range frames are zero and marked invalid),
        ``frame_idx [C+2*halo]`` global frame indices, ``frame_valid
        [B, C+2*halo]`` validity (in-range AND within the track's frame
        count). ``outs`` must be a pytree of arrays with leading dims
        ``[B, C, ...]`` describing the *central* C frames.
      carry_init: ``(B,) -> carry`` pytree initializer.
      chunk_frames: frames per scan step.
      halo: context frames needed on each side (e.g. 0 for per-frame
        features with a carried previous frame; ``margin`` for centered
        time-smoothing).

    Returns:
      (outs, n_frames_total, frame_counts) where ``outs`` has leading dims
      ``[B, n_frames_padded, ...]`` (n_frames_padded = n_chunks*chunk_frames,
      >= n_frames_total) and ``frame_counts [B]`` is each track's valid frame
      count.
    """
    b, t = samples.shape
    nf = num_frames(t, frame_size, hop)
    if nf <= 0:
        # shorter than one frame: run a single all-invalid frame so callers
        # degrade gracefully (the reference returns an empty spectrogram and
        # downstream stages fall back to defaults, e.g. lib.rs:985-1009)
        nf = 1

    n_chunks = -(-nf // chunk_frames)
    nf_padded = n_chunks * chunk_frames

    # Per-track frame counts from per-track lengths.
    frame_counts = jnp.where(
        lengths >= frame_size, (lengths - frame_size) // hop + 1, 0
    ).astype(jnp.int32)

    ext = chunk_frames + 2 * halo
    rlen = region_len(ext, frame_size, hop, bf16, keep_bins)
    # Left-pad by halo*hop so chunk c's extended region starts at padded
    # sample c*chunk_frames*hop (padded frame index = true index + halo) and
    # no slice ever clamps; right-pad so the last chunk's region is whole.
    lpad = halo * hop
    need = (n_chunks - 1) * chunk_frames * hop + rlen
    samples = jnp.pad(samples, ((0, 0), (lpad, max(need - (t + lpad), 0))))

    def body(carry, chunk_idx):
        first_frame = chunk_idx * chunk_frames - halo  # may be negative
        region = jax.lax.dynamic_slice(
            samples, (0, chunk_idx * chunk_frames * hop), (b, rlen)
        )
        spec = chunk_magnitudes(region, ext, frame_size, hop, keep_bins, bf16)
        fidx = first_frame + jnp.arange(ext)
        fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < frame_counts[:, None])
        spec = jnp.where(fvalid[:, :, None], spec, 0.0)
        outs, carry = reducer(spec, fidx, fvalid, carry)
        return carry, outs

    carry0 = carry_init(b)
    _, outs = jax.lax.scan(body, carry0, jnp.arange(n_chunks))

    def fix(x):
        # [n_chunks, B, C, ...] -> [B, n_chunks*C, ...]
        x = jnp.moveaxis(x, 0, 1)
        return x.reshape((b, nf_padded) + x.shape[3:])

    outs = jax.tree_util.tree_map(fix, outs)
    return outs, nf_padded, frame_counts


def mel_filterbank_matrix(
    sample_rate: int, n_bins: int, n_mels: int, fmin_hz: float, fmax_hz: float
) -> np.ndarray:
    """HTK-mel triangular filterbank as a dense ``[n_bins, n_mels]`` matrix.

    Mirrors the reference's integer-bin triangle construction
    (``novelty.rs:78-172``): mel points are converted to *rounded bin indices*
    made strictly increasing, and the rising/falling slopes are computed in
    bin space with zero weight at the triangle feet. Applied to log1p
    magnitudes via one matmul.
    """
    if sample_rate <= 0 or n_bins < 2:
        raise ValueError("invalid mel filterbank params")
    n_mels = max(n_mels, 4)
    nyquist = sample_rate * 0.5
    fmin = min(max(fmin_hz, 0.0), max(nyquist, 1.0))
    fmax = fmax_hz if (np.isfinite(fmax_hz) and fmax_hz > 0.0) else nyquist
    fmax = float(np.clip(fmax, fmin + 1.0, nyquist))

    fft_size = (n_bins - 1) * 2
    freq_res = sample_rate / fft_size

    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def inv_mel(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_min, mel_max = mel(fmin), mel(fmax)
    step = (mel_max - mel_min) / (n_mels + 1)
    hz_points = inv_mel(mel_min + step * np.arange(n_mels + 2))
    bin_points = np.clip(np.round(hz_points / freq_res).astype(np.int64), 0, n_bins - 1)
    for i in range(1, len(bin_points)):
        if bin_points[i] <= bin_points[i - 1]:
            bin_points[i] = min(bin_points[i - 1] + 1, n_bins - 1)

    w = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        left, center, right = bin_points[m], bin_points[m + 1], bin_points[m + 2]
        if not (left < center < right):
            continue
        for bb in range(left, center + 1):
            ww = 0.0 if bb == left else (bb - left) / (center - left)
            if ww > 0:
                w[bb, m] += ww
        for bb in range(center, right + 1):
            ww = 0.0 if bb == right else (right - bb) / (right - center)
            if ww > 0:
                w[bb, m] += ww
    return w


@functools.lru_cache(maxsize=64)
def hz_to_bin(freq_hz: float, freq_resolution: float, n_bins: int) -> int:
    """Rounded, clamped Hz->bin conversion (tempogram.rs:279-289)."""
    if not np.isfinite(freq_hz) or freq_hz <= 0.0 or freq_resolution <= 0.0:
        return 0
    return int(np.clip(round(freq_hz / freq_resolution), 0, max(n_bins - 1, 0)))
