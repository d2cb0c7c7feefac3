"""Batched silence detection and trimming.

Mirror of the reference ``preprocessing/silence.rs:102-279``: frame RMS with
50% overlap, dB threshold, leading/trailing silence trim. In the batched
design the "trim" is a per-track ``dynamic_slice`` shift (content moves to
index 0, new valid length shrinks) so shapes stay static.

Interior silence regions (the full silence map) only affect the reference's
returned metadata, not the trimmed audio; we return per-track leading/trailing
trim points plus the count of interior silent frames for diagnostics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import masked


def frame_rms(samples: jax.Array, lengths: jax.Array, frame_size: int):
    """Per-frame RMS with hop = frame_size/2 (silence.rs:144-169).

    The reference's frame grid uses ``(len - frame)/hop + 1`` frames on the
    per-track length; the final frame is clamped to the signal end. We compute
    on the padded grid and return (rms [B, NF], n_frames [B]).
    """
    b, t = samples.shape
    hop = frame_size // 2
    nf = max((t - frame_size) // hop + 1, 1)
    # Blocked frame sums (ops/framesum.py): exact given zero padding beyond
    # lengths; a per-sample cumsum costs O(log T) passes over the samples.
    from ..ops.framesum import frame_sumsq

    sums = frame_sumsq(samples, frame_size, hop, nf)
    starts = jnp.arange(nf) * hop
    ends = jnp.minimum(starts + frame_size, jnp.maximum(lengths, 1)[:, None])
    ends = jnp.maximum(ends, starts[None, :] + 1)
    cnt = (ends - starts[None, :]).astype(sums.dtype)
    rms = jnp.sqrt(jnp.maximum(sums, 0.0) / cnt)
    n_frames = jnp.where(
        lengths >= frame_size, (lengths - frame_size) // hop + 1, jnp.minimum(lengths, 1)
    ).astype(jnp.int32)
    return rms, n_frames


def detect_and_trim(
    samples: jax.Array,
    lengths: jax.Array,
    sample_rate: int,
    threshold_db: float = -40.0,
    min_duration_ms: int = 500,
    frame_size: int = 2048,
    mesh=None,
):
    """Detect leading/trailing silence and shift each track so content starts
    at index 0. Returns (trimmed_samples [B,T], new_lengths [B], info dict).

    Matches silence.rs semantics:
    * threshold_linear = 10^(dB/20); silent iff rms <= threshold
      (silence.rs:141,174).
    * Leading/trailing regions are trimmed regardless of min_duration
      (silence.rs:199-231).
    * trim_start = frame_starts[first_non_silent_frame] (= end of the leading
      region); trim_end = frame_starts[last_silent_run_start] when the track
      ends silent, else len.
    * Entirely-silent tracks get new_length 0 (callers treat as failed).
    """
    b, t = samples.shape
    hop = frame_size // 2
    threshold_linear = 10.0 ** (threshold_db / 20.0)

    if mesh is not None and "time" in mesh.shape:
        # time-sharded frame RMS (the trim-shift below is left to the SPMD
        # partitioner: one gather pass over the sample axis)
        from ..parallel.timeblocks import frame_rms_sharded

        rms, n_frames = frame_rms_sharded(samples, lengths, frame_size, hop, mesh)
        n_frames = jnp.where(
            lengths >= frame_size, n_frames, jnp.minimum(lengths, 1)
        ).astype(jnp.int32)
    else:
        rms, n_frames = frame_rms(samples, lengths, frame_size)
    nf = rms.shape[1]
    fvalid = masked.length_mask(n_frames, nf)
    silent = (rms <= threshold_linear) & fvalid
    loud = (~silent) & fvalid

    idx = jnp.arange(nf)
    any_loud = jnp.any(loud, axis=-1)
    first_loud = jnp.min(jnp.where(loud, idx[None, :], nf), axis=-1)
    last_loud = jnp.max(jnp.where(loud, idx[None, :], -1), axis=-1)

    # Leading region exists iff frame 0 is silent; it ends at the first
    # non-silent frame -> trim_start = first_loud * hop.
    leading_silent = silent[:, 0]
    trim_start = jnp.where(leading_silent & any_loud, first_loud * hop, 0)

    # Trailing: the final silent run starts at last_loud+1; its start sample is
    # frame_starts[last_loud+1] (silence.rs:222-231 uses frame_starts of the
    # run's first frame).
    last_frame_silent = jnp.take_along_axis(
        silent, jnp.maximum(n_frames - 1, 0)[:, None], axis=-1
    )[:, 0]
    trailing_start_frame = jnp.minimum(last_loud + 1, jnp.maximum(n_frames - 1, 0))
    trim_end = jnp.where(
        last_frame_silent & any_loud, trailing_start_frame * hop, lengths
    )
    trim_end = jnp.minimum(trim_end, lengths)

    trim_start = jnp.where(any_loud, trim_start, 0)
    trim_end = jnp.where(any_loud, trim_end, 0)
    trim_start = jnp.minimum(trim_start, trim_end)
    new_lengths = (trim_end - trim_start).astype(jnp.int32)

    def do_shift(s):
        def shift_one(x, st):
            return jax.lax.dynamic_slice(x, (st,), (t,))

        padded = jnp.pad(s, ((0, 0), (0, t)))
        out = jax.vmap(shift_one)(padded, trim_start.astype(jnp.int32))
        return jnp.where(masked.length_mask(new_lengths, t), out, 0.0)

    def mask_only(s):
        return jnp.where(masked.length_mask(new_lengths, t), s, 0.0)

    # The shift is a full [B, 2T] pad + per-track gather + mask (~1.5 GB of
    # HBM traffic for a 3-min batch). Tiered batch-level conds: no track
    # trims (clean studio tracks) -> identity; only TRAILING silence trims
    # (tracks that end in a fade — content already starts at 0) -> one
    # fused mask pass; any leading trim -> the full shift.
    any_lead = jnp.any(trim_start > 0)
    any_tail = jnp.any(trim_end < lengths)
    shifted = jax.lax.cond(
        any_lead,
        do_shift,
        lambda s: jax.lax.cond(any_tail, mask_only, lambda x: x, s),
        samples,
    )

    # Interior silence diagnostics: silent frames not part of the lead/tail runs.
    interior_silent = silent & (idx[None, :] >= first_loud[:, None]) & (
        idx[None, :] <= last_loud[:, None]
    )
    info = {
        "trim_start": trim_start.astype(jnp.int32),
        "trim_end": trim_end.astype(jnp.int32),
        "interior_silent_frames": jnp.sum(interior_silent, axis=-1).astype(jnp.int32),
        "all_silent": ~any_loud,
    }
    return shifted, new_lengths, info
