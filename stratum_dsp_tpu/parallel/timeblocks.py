"""Time-block ("sequence parallel") sharding of the sample-domain frontends.

The analogue of context parallelism for this workload (SURVEY §2.3): a long
track's sample axis is sharded into contiguous blocks across a ``time`` mesh
axis. The STFT needs ``frame_size - hop`` samples of right-neighbor context
for frames that straddle a block boundary (overlap-save) plus left context
for the flux reducers' previous-frame carries and the key path's ±margin
conditioning halo — all exchanged with one ``jax.lax.ppermute`` per side.
Each device computes its block's frames with the SAME streaming reducer as
the single-device path (``ops.stft.stft_reduce`` contract); the resulting
per-frame features are tiny (~14 floats/frame vs 2048 samples/hop of audio),
so they are ``all_gather``-ed along the time axis and every device finishes
the (cheap) novelty/estimator stages on the full curves.

Layout requirements: ``T % (n_time * hop) == 0`` and ``frame_size % hop == 0``
(true for every config the pipeline uses: 2048/{256,512,1024}, 8192/512).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import AnalysisConfig
from ..features.period import novelty as nov
from ..ops import masked as masked_ops
from ..ops.stft import chunk_magnitudes, region_len


def pad_to_time_multiple(samples: jax.Array, n_time: int, quantum: int):
    """Right-pad ``[B, T]`` so T is a multiple of ``n_time * quantum``."""
    b, t = samples.shape
    m = n_time * quantum
    t_pad = -(-t // m) * m
    if t_pad != t:
        samples = jnp.pad(samples, ((0, 0), (0, t_pad - t)))
    return samples


def stft_reduce_sharded(
    samples: jax.Array,
    lengths: jax.Array,
    frame_size: int,
    hop: int,
    reducer: Callable,
    carry_init: Callable,
    mesh: Mesh,
    *,
    prev_frames: int = 2,
    halo_frames: int = 0,
    keep_bins: Optional[int] = None,
    chunk_frames: int = 512,
    out_template: Optional[Dict] = None,
    bf16: bool = False,
):
    """Time-sharded equivalent of ``ops.stft.stft_reduce``.

    ``samples [B, T]`` sharded ``P("tracks", "time")`` (T divisible by
    ``n_time * hop``); same reducer contract as ``stft_reduce`` — the reducer
    sees GLOBAL frame indices, per-chunk spec with ``halo_frames`` context on
    each side, and a carry threaded across this block's chunks.

    ``prev_frames``: how many previous spectral frames the carry represents;
    the block's initial carry is computed from real left-neighbor samples
    (the last ``prev_frames`` frames before the block), so results are
    bit-identical to the single-device scan except at track start where both
    use zeros.

    ``out_template``: dict with the reducer's output keys (values ignored) —
    required because shard_map needs static out_specs. If None, the reducer
    is abstractly evaluated to discover them.

    Returns (outs [B, nf_padded, ...] replicated along time, nf_padded,
    frame_counts [B]).
    """
    b, t = samples.shape
    n_time = mesh.shape["time"]
    assert frame_size % hop == 0, "frame_size must be a hop multiple"
    assert t % (n_time * hop) == 0, (
        f"padded length {t} must be divisible by n_time*hop = {n_time * hop}"
    )
    t_blk = t // n_time
    fpb = t_blk // hop  # frames starting in each block
    lead = prev_frames + halo_frames
    trail = halo_frames
    left_ctx = lead * hop
    right_ctx = trail * hop + (frame_size - hop)
    nf_total = max((t - frame_size) // hop + 1, 0)

    frame_counts = jnp.where(
        lengths >= frame_size, (lengths - frame_size) // hop + 1, 0
    ).astype(jnp.int32)

    chunk = int(min(chunk_frames, fpb))
    n_chunks = -(-fpb // chunk)
    ext_chunk = chunk + 2 * halo_frames
    rlen = region_len(ext_chunk, frame_size, hop, bf16, keep_bins)
    # samples the last chunk's region reaches past the block's right context
    # (n_chunks * chunk may exceed fpb): zero-padded, they only feed frames
    # past fpb, which are dropped
    ext_len = (lead + (n_chunks - 1) * chunk - halo_frames) * hop + rlen
    right_pad = max(ext_len - (left_ctx + t_blk + right_ctx), 0)

    if out_template is None:
        k_bins = keep_bins if keep_bins is not None else frame_size // 2 + 1
        spec_shape = (b, chunk + 2 * halo_frames, k_bins)
        outs_shape = jax.eval_shape(
            lambda s, f, v, c: reducer(s, f, v, c)[0],
            jax.ShapeDtypeStruct(spec_shape, jnp.float32),
            jax.ShapeDtypeStruct((chunk + 2 * halo_frames,), jnp.int32),
            jax.ShapeDtypeStruct(spec_shape[:2], jnp.bool_),
            jax.eval_shape(lambda: carry_init(b)),
        )
        out_template = outs_shape

    def block_fn(block, fc):
        # block: [B_loc, T_blk]; fc: frame counts replicated over time
        ti = jax.lax.axis_index("time")
        d = jax.lax.axis_size("time")
        bloc = block.shape[0]
        right_perm = [(i, (i - 1) % d) for i in range(d)]
        left_perm = [(i, (i + 1) % d) for i in range(d)]
        recv_right = jax.lax.ppermute(block[:, :right_ctx], "time", right_perm)
        recv_left = jax.lax.ppermute(block[:, -left_ctx:], "time", left_perm) \
            if left_ctx > 0 else jnp.zeros((bloc, 0), block.dtype)
        ext = jnp.concatenate(
            [recv_left, block, recv_right, jnp.zeros((bloc, right_pad), block.dtype)],
            axis=1,
        )
        # ext frame k starts at ext sample k*hop; central frames are
        # k in [lead, lead+fpb); global frame index = ti*fpb + (k - lead)
        first_global = ti * fpb

        # block carry: the real previous frames' spectra (zero at track start
        # because ppermute wraps — those frames are invalid and zeroed)
        if prev_frames > 0:
            pspec = chunk_magnitudes(ext, prev_frames, frame_size, hop, keep_bins, bf16)
            pidx = first_global - prev_frames + jnp.arange(prev_frames)
            pvalid = (pidx[None, :] >= 0) & (pidx[None, :] < fc[:, None])
            pspec = jnp.where(pvalid[..., None], pspec, 0.0)
            carry0 = _carry_from_prev(carry_init, bloc, pspec)
        else:
            carry0 = carry_init(bloc)

        def body(carry, ci):
            # central frames [ci*chunk, ci*chunk + chunk) of this block
            k0 = lead + ci * chunk - halo_frames  # >= 0 since lead >= halo
            region = jax.lax.dynamic_slice(ext, (0, k0 * hop), (bloc, rlen))
            spec = chunk_magnitudes(region, ext_chunk, frame_size, hop, keep_bins, bf16)
            fidx = first_global + ci * chunk - halo_frames + jnp.arange(ext_chunk)
            fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < fc[:, None])
            fvalid = fvalid & (fidx[None, :] < nf_total)
            spec = jnp.where(fvalid[:, :, None], spec, 0.0)
            outs, carry = reducer(spec, fidx, fvalid, carry)
            return carry, outs

        _, outs = jax.lax.scan(body, carry0, jnp.arange(n_chunks))

        def fix(x):
            x = jnp.moveaxis(x, 0, 1)  # [B, n_chunks, C, ...]
            x = x.reshape((bloc, n_chunks * chunk) + x.shape[3:])
            return x[:, :fpb]

        outs = jax.tree_util.tree_map(fix, outs)
        return jax.tree_util.tree_map(
            lambda x: jax.lax.all_gather(x, "time", axis=1, tiled=True), outs
        )

    out_specs = jax.tree_util.tree_map(lambda _: P("tracks"), out_template)
    outs = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=(P("tracks", "time"), P("tracks")),
        out_specs=out_specs,
        check_vma=False,
    )(samples, frame_counts)
    return outs, n_time * fpb, frame_counts


def _carry_from_prev(carry_init, b, prev_spec):
    """Build the reducer carry from the real previous frames' spectra.

    The pipeline's flux reducers carry the last ``prev_frames`` raw magnitude
    frames as ``[B, prev, K]``; reducers with a different carry structure
    (all are unused/zeros in this codebase) fall back to ``carry_init``.
    """
    c0 = carry_init(b)
    if hasattr(c0, "shape") and c0.shape == prev_spec.shape:
        return prev_spec
    return c0


def frame_rms_sharded(
    samples: jax.Array,
    lengths: jax.Array,
    frame_size: int,
    hop: int,
    mesh: Mesh,
):
    """Time-sharded per-frame RMS on the reference frame grid
    (energy_flux.rs:105-131 / silence.rs:144-169 semantics: frames at i*hop,
    clamped to the per-track end).

    Requires ``T % (n_time * hop) == 0``. Returns (rms [B, NF] replicated
    along time, n_frames [B]). NF = T // hop (padded grid; frames whose
    window would start past T-frame_size are still emitted — callers mask by
    n_frames exactly as with the dense implementations).
    """
    b, t = samples.shape
    n_time = mesh.shape["time"]
    assert t % (n_time * hop) == 0
    t_blk = t // n_time
    fpb = t_blk // hop
    right_ctx = frame_size - hop

    def block_fn(block, ln):
        ti = jax.lax.axis_index("time")
        d = jax.lax.axis_size("time")
        bloc = block.shape[0]
        right_perm = [(i, (i - 1) % d) for i in range(d)]
        recv_right = jax.lax.ppermute(block[:, :right_ctx], "time", right_perm)
        ext = jnp.concatenate([block, recv_right], axis=1)
        # clamp-to-end semantics: zero samples at/after the track length
        base = ti * t_blk
        gidx = base + jnp.arange(ext.shape[1])
        ext = jnp.where(gidx[None, :] < ln[:, None], ext, 0.0)
        x2 = ext * ext
        c = jnp.concatenate(
            [jnp.zeros((bloc, 1), x2.dtype), jnp.cumsum(x2, axis=-1)], axis=-1
        )
        starts = jnp.arange(fpb) * hop
        g_starts = base + starts
        ends = jnp.minimum(
            g_starts[None, :] + frame_size, jnp.maximum(ln, 1)[:, None]
        )
        ends = jnp.maximum(ends, g_starts[None, :] + 1)
        l_ends = jnp.clip(ends - base, 0, ext.shape[1])
        sums = jnp.take_along_axis(c, l_ends, axis=-1) - c[:, starts]
        cnt = (ends - g_starts[None, :]).astype(x2.dtype)
        rms = jnp.sqrt(jnp.maximum(sums, 0.0) / jnp.maximum(cnt, 1.0))
        return jax.lax.all_gather(rms, "time", axis=1, tiled=True)

    rms = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=(P("tracks", "time"), P("tracks")),
        out_specs=P("tracks"),
        check_vma=False,
    )(samples, lengths)
    n_frames = jnp.where(
        lengths >= frame_size, (lengths - frame_size) // hop + 1, 0
    ).astype(jnp.int32)
    return rms, n_frames


def compute_bpm_spectral_features_sharded(
    samples: jax.Array,
    lengths: jax.Array,
    cfg: AnalysisConfig,
    sample_rate: int,
    frame_size: int,
    hop: int,
    mesh: Mesh,
    chunk_frames: int = 512,
    emit_stride2=None,
    emit_onset_flux: bool = True,
):
    """Time-sharded ``novelty.compute_bpm_spectral_features`` (same returns)."""
    reducer, carry_init, band_names = nov.make_bpm_reducer(
        cfg, sample_rate, frame_size,
        emit_stride2=emit_stride2, emit_onset_flux=emit_onset_flux,
    )
    outs, nf_padded, frame_counts = stft_reduce_sharded(
        samples, lengths, frame_size, hop, reducer, carry_init, mesh,
        prev_frames=2, chunk_frames=chunk_frames, bf16=cfg.stft_bf16,
    )
    outs["band_names"] = band_names
    return outs, frame_counts, nf_padded
