"""Beat-grid assembly: HMM track -> variation refine -> time signature ->
downbeats -> stability.

Mirror of reference ``beat_tracking/mod.rs:108-485`` (``generate_beat_grid``).
All stages batched over fixed-capacity beat tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import hmm, time_signature as ts
from .variation import BIG, compact_sorted, refine_beats

EPSILON = 1e-10


class BeatGridTensor(NamedTuple):
    """Device-side beat grid for a batch."""

    beat_times: jax.Array  # [B, N] seconds, compacted ascending
    beat_valid: jax.Array  # [B, N]
    downbeat_times: jax.Array  # [B, N]
    downbeat_valid: jax.Array  # [B, N]
    stability: jax.Array  # [B]
    time_signature: jax.Array  # [B] int32 (0=4/4, 1=3/4, 2=6/8)
    time_signature_confidence: jax.Array  # [B]
    has_tempo_variation: jax.Array  # [B] bool
    ok: jax.Array  # [B] bool — False mirrors the reference's error returns


def detect_downbeats(
    times: jax.Array, n_beats: jax.Array, bpm: jax.Array, sig_index: jax.Array
):
    """Greedy downbeat marking (mod.rs:363-404): first beat is a downbeat;
    each later beat is one if within ±10% of one bar after the last downbeat.
    ``times`` compacted ascending. Returns a boolean mask over slots."""
    beats_per_bar = jnp.asarray(ts.BEATS_PER_BAR)[sig_index]
    bar = (60.0 / jnp.maximum(bpm, EPSILON)) * beats_per_bar
    tol = bar * 0.1
    mb = times.shape[-1]
    slot_valid = jnp.arange(mb)[None, :] < n_beats[:, None]

    def step(carry, inp):
        last_db, any_db = carry
        t, ok = inp
        first = ok & ~any_db
        hit = ok & any_db & (jnp.abs(t - (last_db + bar)) <= tol)
        is_db = first | hit
        last_db = jnp.where(is_db, t, last_db)
        any_db = any_db | is_db
        return (last_db, any_db), is_db

    init = (jnp.zeros_like(bpm), jnp.zeros_like(bpm, dtype=bool))
    _, db = jax.lax.scan(
        step, init, (jnp.moveaxis(times, 1, 0), jnp.moveaxis(slot_valid, 1, 0)),
        unroll=16,
    )
    return jnp.moveaxis(db, 0, 1)


def grid_stability(times: jax.Array, n_beats: jax.Array):
    """1/(1+CV) over positive beat intervals (mod.rs:425-485); < 2 beats -> 0."""
    v, m = ts.positive_intervals(times, n_beats)
    mf = jnp.maximum(m, 1).astype(jnp.float32)
    imask = jnp.arange(v.shape[-1])[None, :] < m[:, None]
    mean = jnp.sum(jnp.where(imask, v, 0.0), axis=-1) / mf
    var = jnp.sum(jnp.where(imask, (v - mean[:, None]) ** 2, 0.0), axis=-1) / mf
    cv = jnp.sqrt(var) / jnp.maximum(mean, EPSILON)
    stab = 1.0 / (1.0 + cv)
    return jnp.where((n_beats >= 2) & (m >= 1) & (mean > 1e-10), stab, 0.0)


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def search_phase_anchor(
    bpm: jax.Array,
    onset_times: jax.Array,
    onset_valid: jax.Array,
    novelty: jax.Array,
    novelty_n: jax.Array,
    frame_rate: float,
    max_beats: int,
    n_offsets: int = 32,
) -> jax.Array:
    """Novelty-optimized beat-grid phase anchor ([B] seconds).

    The reference anchors the grid at the FIRST detected onset
    (hmm.rs:241-249), which phase-locks to the offbeat whenever the first
    onset is not on-beat — measured on the synthetic battery: a track-
    opening kick at t=0 has no preceding baseline frame for the flux
    derivative, so the first *detected* onset is an offbeat eighth hat and
    every downstream beat inherits its phase. This search instead scores
    ``n_offsets`` candidate phases across one beat interval around the
    first onset by the mean novelty at their grid positions (accented
    on-beat events carry more spectral flux than offbeat hats — the same
    signal the multi-res beat-contrast alignment uses,
    multi_resolution.rs:580-678) and returns the best, with an epsilon
    preference for the reference's own anchor on flat ties.
    """
    b = bpm.shape[0]
    safe_bpm = jnp.where(bpm > EPSILON, bpm, 120.0)
    interval = 60.0 / safe_bpm  # [B]
    start = jnp.min(jnp.where(onset_valid, onset_times, 1e9), axis=-1)
    start = jnp.where(jnp.any(onset_valid, axis=-1), start, 0.0)

    offs = (jnp.arange(n_offsets, dtype=jnp.float32) / n_offsets - 0.5)  # [P]
    anchors = start[:, None] + offs[None, :] * interval[:, None]  # [B, P]
    # sample every 4th beat: phase scoring is statistical (>=110 samples on
    # a 3-min track), and the [B, P, K] gather is the stage's whole cost
    # (stride 4 leaves every battery grid unchanged)
    k = jnp.arange(max_beats // 4, dtype=jnp.float32) * 4.0  # [MB/4]
    grid = anchors[:, :, None] + k[None, None, :] * interval[:, None, None]
    fidx = jnp.round(grid * frame_rate).astype(jnp.int32)  # [B, P, MB]
    in_range = (fidx >= 0) & (fidx < novelty_n[:, None, None])
    # 3-tap max over {f-1, f, f+1}: a novelty peak is 1-2 frames wide, so a
    # single rounded-frame sample can fall one frame off the peak and read
    # ~0 — the offset-grid quantization (interval / n_offsets ~ 16-20 ms)
    # plus frame rounding (~11.6 ms at hop 512) exceeds the peak width
    nmax = jnp.maximum(
        novelty,
        jnp.maximum(
            jnp.concatenate([novelty[:, 1:], novelty[:, :1] * 0.0], axis=-1),
            jnp.concatenate([novelty[:, :1] * 0.0, novelty[:, :-1]], axis=-1),
        ),
    )
    fidx = jnp.clip(fidx, 0, novelty.shape[-1] - 1)
    vals = jnp.take_along_axis(
        nmax[:, None, :], jnp.reshape(fidx, (b, -1))[:, None, :], axis=-1
    ).reshape(b, n_offsets, max_beats // 4)
    vals = jnp.where(in_range, vals, 0.0)
    score = jnp.sum(vals, axis=-1) / jnp.maximum(
        jnp.sum(in_range, axis=-1).astype(jnp.float32), 1.0
    )  # [B, P]
    # flat-tie preference for the reference anchor (offset 0): a relative
    # epsilon bonus keeps parity when the novelty cannot separate phases
    ref_j = n_offsets // 2  # offs[P/2] == 0.0
    score = score.at[:, ref_j].mul(1.0 + 1e-4)
    best = jnp.argmax(score, axis=-1)  # [B]
    anchor = jnp.take_along_axis(anchors, best[:, None], axis=-1)[:, 0]
    # snap to the nearest detected onset when one sits within a quarter
    # interval: onset positions (~hop precision) are sharper than the
    # offset grid (interval / n_offsets) + novelty frame quantization, and
    # the reference's grid is onset-anchored by construction
    k_on = onset_times.shape[-1]
    o_sorted = jnp.where(onset_valid, onset_times, 1e9)
    n_on = jnp.sum(onset_valid, axis=-1)

    def nearest(a, o, nv):
        i = jnp.searchsorted(o, a)
        lo = jnp.clip(i - 1, 0, k_on - 1)
        hi = jnp.clip(i, 0, k_on - 1)
        d_lo = jnp.where(i > 0, jnp.abs(a - o[lo]), 1e9)
        d_hi = jnp.where(i < nv, jnp.abs(a - o[hi]), 1e9)
        t = jnp.where(d_lo <= d_hi, o[lo], o[hi])
        return t, jnp.minimum(d_lo, d_hi)

    snap_t, snap_d = jax.vmap(nearest)(anchor, o_sorted, n_on)
    return jnp.where(snap_d < interval * 0.25, snap_t, anchor)


def search_downbeat_phase(
    grid: "BeatGridTensor",
    novelty: jax.Array,
    novelty_n: jax.Array,
    frame_rate: float,
) -> "BeatGridTensor":
    """Re-phase the downbeats by accent evidence (extension, config
    ``enable_downbeat_phase_search``; no reference counterpart — the
    reference's first-tracked-beat-is-a-downbeat convention, mod.rs:363-404,
    leaves the bar phase arbitrary). Scores every rotation r <
    beats_per_bar of the compacted beat list by mean 3-tap-max low-band
    novelty at the candidate downbeats (bar-start accents carry more
    low-band energy) and rebuilds the downbeat prefix at the winning
    rotation, with an epsilon preference for the reference's r=0."""
    from . import time_signature as ts

    bt, bvalid = grid.beat_times, grid.beat_valid
    b, n = bt.shape
    bpb = jnp.asarray(ts.BEATS_PER_BAR)[grid.time_signature]  # [B]
    max_bpb = int(max(ts.BEATS_PER_BAR))

    nmax = jnp.maximum(
        novelty,
        jnp.maximum(
            jnp.concatenate([novelty[:, 1:], novelty[:, :1] * 0.0], axis=-1),
            jnp.concatenate([novelty[:, :1] * 0.0, novelty[:, :-1]], axis=-1),
        ),
    )
    fidx = jnp.round(bt * frame_rate).astype(jnp.int32)
    in_r = bvalid & (fidx >= 0) & (fidx < novelty_n[:, None])
    vals = jnp.take_along_axis(
        nmax, jnp.clip(fidx, 0, novelty.shape[-1] - 1), axis=-1
    )
    vals = jnp.where(in_r, vals, 0.0)  # [B, N]

    i = jnp.arange(n)
    scores = []
    for r in range(max_bpb):
        m = in_r & (jnp.mod(i[None, :] - r, bpb[:, None]) == 0)
        s = jnp.sum(jnp.where(m, vals, 0.0), axis=-1) / jnp.maximum(
            jnp.sum(m, axis=-1).astype(jnp.float32), 1.0
        )
        scores.append(jnp.where(r < bpb, s, -1.0))
    sc = jnp.stack(scores, axis=-1)  # [B, max_bpb]
    sc = sc.at[:, 0].mul(1.0 + 1e-4)  # flat-tie: keep the reference phase
    best_r = jnp.argmax(sc, axis=-1)  # [B]

    db_mask = bvalid & (jnp.mod(i[None, :] - best_r[:, None], bpb[:, None]) == 0)
    db_key = jnp.where(db_mask, bt, BIG)
    db_sorted = jnp.sort(db_key, axis=-1)
    db_valid = db_sorted < BIG * 0.5
    db_times = jnp.where(db_valid, db_sorted, 0.0)
    return grid._replace(
        downbeat_times=jnp.where(grid.ok[:, None], db_times, 0.0),
        downbeat_valid=db_valid & grid.ok[:, None],
    )


@functools.partial(jax.jit, static_argnums=(4, 5))
def fit_grid_drift(
    anchor: jax.Array,
    bpm: jax.Array,
    onset_times: jax.Array,
    onset_valid: jax.Array,
    max_beats: int,
    n_iter: int = 4,
):
    """Weighted least-squares refit of (anchor, interval) against matched
    onsets. Returns (anchor', interval_scale') with interval' =
    (60/bpm) * interval_scale'.

    A +-1 BPM estimate error (inside the product's +-2 tolerance) drifts a
    rigid nominal grid by ~9 ms per beat — past the 70 ms beat F-measure
    window within ~8 s — so grid accuracy was capped by BPM quantization,
    not by tracking (battery: swing family F 0.46 with exact-family BPM).
    Each iteration matches every k-th grid beat to its nearest onset within
    0.12 interval and solves the weighted regression o_k ~= a + k*I.
    Guards: >= 16 matches and a fitted interval within 2% of nominal, else
    the inputs pass through unchanged (e.g. sparse or offbeat-dense onset
    lists). Extension (no reference counterpart: the reference's grid uses
    the nominal interval from the BPM estimate, hmm.rs:247-249, 404-409).
    """
    k_on = onset_times.shape[-1]
    o_sorted = jnp.where(onset_valid, onset_times, 1e9)
    n_on = jnp.sum(onset_valid, axis=-1)
    interval0 = 60.0 / jnp.maximum(bpm, EPSILON)
    k = jnp.arange(max_beats, dtype=jnp.float32)

    def nearest(a_row, o_row, nv):
        i = jnp.searchsorted(o_row, a_row)
        lo = jnp.clip(i - 1, 0, k_on - 1)
        hi = jnp.clip(i, 0, k_on - 1)
        d_lo = jnp.where(i > 0, jnp.abs(a_row - o_row[lo]), 1e9)
        d_hi = jnp.where(i < nv, jnp.abs(a_row - o_row[hi]), 1e9)
        t = jnp.where(d_lo <= d_hi, o_row[lo], o_row[hi])
        return t, jnp.minimum(d_lo, d_hi)

    # Robust median fit, NOT least squares: when the estimate is ~1 BPM off,
    # late grid beats drift onto a parallel event lattice (e.g. swing hats
    # at 0.6·I), and an LS slope over the mixed matches splits the
    # difference. Both lattices share the TRUE spacing, so the MEDIAN of
    # adjacent matched-onset diffs recovers the interval regardless of
    # which lattice each beat matched; the anchor is then the median
    # residual (majority lattice wins). The match window anneals as the
    # interval converges, shedding the wrong-lattice matches.
    from ...ops import masked

    a = anchor
    scale = jnp.ones_like(anchor)
    # four gently-annealing windows: on mixed-lattice content (swing) the
    # anchor median needs two mid-width passes to settle on the majority
    # lattice before the tight windows shed the wrong one (measured: 2
    # iterations or STRIDED slots lose the swing family's rescue). The fit
    # runs on the first 256 slots — dense slots are what annealing needs;
    # 256 beats span 90-180 s at production tempos, and the matching
    # searchsorted is the fit's whole device cost.
    windows = (0.12, 0.10, 0.07, 0.05)
    k = k[: min(max_beats, 256)]
    for it in range(n_iter):
        interval = interval0 * scale
        grid = a[:, None] + k[None, :] * interval[:, None]  # [B, MB]
        o, d = jax.vmap(nearest)(grid, o_sorted, n_on)
        win = windows[min(it, len(windows) - 1)]
        w = d < win * interval[:, None]
        # consecutive MATCHED slots (arbitrary gap, e.g. a backbeat grid
        # only matches onsets every other beat): compact matches to a
        # prefix, slope = onset diff / slot gap, gaps capped at 4 beats
        ordidx = jnp.argsort(~w, axis=-1, stable=True)
        o_c = jnp.take_along_axis(o, ordidx, axis=-1)
        k_c = jnp.take_along_axis(
            jnp.broadcast_to(k[None, :], o.shape), ordidx, axis=-1
        )
        n_m = jnp.sum(w, axis=-1)
        gap = k_c[:, 1:] - k_c[:, :-1]
        slope = (o_c[:, 1:] - o_c[:, :-1]) / jnp.maximum(gap, 1.0)
        pair_ok = (
            (jnp.arange(o.shape[-1] - 1)[None, :] < (n_m - 1)[:, None])
            & (gap >= 1.0) & (gap <= 4.0)
        )
        i_fit = masked.masked_median(slope, pair_ok)  # [B]
        rel = i_fit / jnp.maximum(interval0, EPSILON)
        # >= 8 adjacent matched pairs and a fitted interval within 2% of
        # nominal, else pass through unchanged (sparse/offbeat onset lists).
        # A slope-MAD consistency guard was tried and REVERTED: it rejects
        # noise-floor fits (which score ~0 either way) but also fits whose
        # median is excellent under moderate spread (fullmix downbeat F
        # 1.0 -> 0.38) — the median is already the robust estimator.
        ok = (jnp.sum(pair_ok, axis=-1) >= 8) & (jnp.abs(rel - 1.0) < 0.02)
        r = o - k[None, :] * (interval0 * jnp.where(ok, rel, scale))[:, None]
        a_fit = masked.masked_median(r, w)
        a = jnp.where(ok, a_fit, a)
        scale = jnp.where(ok, rel, scale)
    return a, scale


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 9))
def generate_beat_grid(
    bpm: jax.Array,
    bpm_confidence: jax.Array,
    onset_times: jax.Array,
    onset_valid: jax.Array,
    max_beats: int = 1024,
    seg_beat_cap: int = 64,
    max_segments: int = 48,
    anchor: jax.Array | None = None,
    interval_scale: jax.Array | None = None,
    fill: bool = False,
) -> BeatGridTensor:
    """Full grid generation for a batch (mod.rs:108-250).

    ``onset_times [B, K]`` seconds, sorted among valid entries. The segment
    capacity bounds cover a 3-min track: 48 half-overlapped 4-8 s segments
    and 64 beats per 8 s segment (>= 300 BPM headroom).
    """
    n_onsets = jnp.sum(onset_valid, axis=-1)
    ok = (bpm > 0.0) & (bpm <= 300.0) & (n_onsets >= 1)

    beats, _states = hmm.track_beats(
        bpm, onset_times, onset_valid, max_beats, anchor, interval_scale, fill
    )
    any_beats = jnp.any(beats.valid, axis=-1)
    ok = ok & any_beats

    refined, has_variation = refine_beats(
        beats, bpm, bpm_confidence, onset_times, onset_valid, seg_beat_cap, max_segments
    )

    btimes, n_beats = compact_sorted(refined.times, refined.valid)
    slot_valid = jnp.arange(btimes.shape[-1])[None, :] < n_beats[:, None]
    btimes = jnp.where(slot_valid, btimes, 0.0)

    sig, sig_conf = ts.detect_time_signature(btimes, slot_valid, n_beats)
    db_mask = detect_downbeats(btimes, n_beats, bpm, sig)
    stability = grid_stability(btimes, n_beats)

    # compact downbeats to a prefix
    db_key = jnp.where(db_mask, btimes, BIG)
    db_sorted = jnp.sort(db_key, axis=-1)
    db_valid = db_sorted < BIG * 0.5
    db_times = jnp.where(db_valid, db_sorted, 0.0)

    return BeatGridTensor(
        beat_times=jnp.where(ok[:, None], btimes, 0.0),
        beat_valid=slot_valid & ok[:, None],
        downbeat_times=jnp.where(ok[:, None], db_times, 0.0),
        downbeat_valid=db_valid & ok[:, None],
        stability=jnp.where(ok, stability, 0.0),
        time_signature=sig,
        time_signature_confidence=sig_conf,
        has_tempo_variation=has_variation & ok,
        ok=ok,
    )
