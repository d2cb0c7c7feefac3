"""Masked-array utilities.

The batched pipeline keeps every per-track quantity at a static padded shape and
threads per-track valid lengths/masks through the computation. These helpers
implement the reference's variable-length scalar loops as mask-aware tensor
ops; window clamping at array edges matches the reference's
``saturating_sub``/``min`` boundary handling (e.g. ``novelty.rs:947-986``)
because the valid region always starts at index 0 after trimming.

All functions operate on the **last** axis unless stated otherwise and are
batch-agnostic (leading axes broadcast).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPSILON = 1e-10


def length_mask(n: jax.Array, size: int) -> jax.Array:
    """Boolean mask [..., size] that is True for indices < n (n broadcastable)."""
    idx = jnp.arange(size)
    return idx < jnp.asarray(n)[..., None]


def masked_max(x: jax.Array, mask: jax.Array, initial: float = 0.0) -> jax.Array:
    """Max over the last axis counting only masked entries."""
    return jnp.max(jnp.where(mask, x, initial), axis=-1)


def masked_sum(x: jax.Array, mask: jax.Array) -> jax.Array:
    return jnp.sum(jnp.where(mask, x, 0.0), axis=-1)


def masked_mean(x: jax.Array, mask: jax.Array) -> jax.Array:
    cnt = jnp.maximum(jnp.sum(mask, axis=-1), 1)
    return masked_sum(x, mask) / cnt


def normalize_by_max(x: jax.Array, mask: jax.Array) -> jax.Array:
    """Divide by masked max if > EPSILON (reference ``normalize_in_place``,
    novelty.rs:935-942). Returns x unchanged where max is tiny."""
    mx = masked_max(x, mask)[..., None]
    return jnp.where(mx > EPSILON, x / jnp.maximum(mx, EPSILON), x)


def _window_sums(x: jax.Array, half_left: int, half_right: int) -> jax.Array:
    """Sliding-window sums of x over [i-half_left, i+half_right] clamped to the
    array bounds, via padded cumulative sums (O(N))."""
    c = jnp.cumsum(x, axis=-1)
    n = x.shape[-1]
    zeros = jnp.zeros_like(c[..., :1])
    c0 = jnp.concatenate([zeros, c], axis=-1)  # c0[i] = sum of x[0:i]
    idx = jnp.arange(n)
    lo = jnp.clip(idx - half_left, 0, n)
    hi = jnp.clip(idx + half_right + 1, 0, n)
    return jnp.take(c0, hi, axis=-1) - jnp.take(c0, lo, axis=-1)


def moving_average(x: jax.Array, mask: jax.Array, window: int) -> jax.Array:
    """Centered moving average with window clamped at the *valid* boundary.

    Matches reference ``smooth_moving_average_in_place`` (novelty.rs:970-986):
    window = [i - w//2, i + w//2] clipped to [0, n_valid); denominator is the
    clipped window length. Invalid (padding) entries contribute 0 and are not
    counted.
    """
    if window <= 1:
        return x
    half = window // 2
    xm = jnp.where(mask, x, 0.0)
    sums = _window_sums(xm, half, half)
    cnts = _window_sums(mask.astype(x.dtype), half, half)
    out = sums / jnp.maximum(cnts, 1.0)
    return jnp.where(mask, out, x)


def local_mean_subtract(x: jax.Array, mask: jax.Array, window: int) -> jax.Array:
    """max(0, x - centered moving mean) (novelty.rs:947-967)."""
    if window == 0:
        return x
    half = max(window, 1) // 2
    xm = jnp.where(mask, x, 0.0)
    sums = _window_sums(xm, half, half)
    cnts = _window_sums(mask.astype(x.dtype), half, half)
    mean = sums / jnp.maximum(cnts, 1.0)
    out = jnp.maximum(x - mean, 0.0)
    return jnp.where(mask, out, x)


def max_pool_1d(x: jax.Array, radius: int) -> jax.Array:
    """Sliding max over [i-radius, i+radius] on the last axis (edge-clamped).

    Used by SuperFlux's frequency-neighborhood max filter
    (novelty.rs:364-374). Implemented with ``lax.reduce_window`` so XLA lowers
    it to a vectorized windowed reduction.
    """
    if radius <= 0:
        return x
    window = 2 * radius + 1
    rank = x.ndim
    dims = [1] * (rank - 1) + [window]
    strides = [1] * rank
    pads = [(0, 0)] * (rank - 1) + [(radius, radius)]
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, tuple(dims), tuple(strides), tuple(pads)
    )


def windowed_any(x: jax.Array, left: int, right: int) -> jax.Array:
    """Boolean OR over window [i-left, i+right] on the last axis."""
    rank = x.ndim
    window = left + right + 1
    dims = [1] * (rank - 1) + [window]
    strides = [1] * rank
    pads = [(0, 0)] * (rank - 1) + [(left, right)]
    return jax.lax.reduce_window(
        x.astype(jnp.bool_), False, jax.lax.bitwise_or, tuple(dims), tuple(strides), tuple(pads)
    )


def masked_sort(x: jax.Array, mask: jax.Array, fill: float = jnp.inf) -> jax.Array:
    """Ascending sort with invalid entries pushed to the end (filled with +inf)."""
    return jnp.sort(jnp.where(mask, x, fill), axis=-1)


def masked_percentile_value(x: jax.Array, mask: jax.Array, pct: float) -> jax.Array:
    """The reference's percentile threshold: sort valid values ascending, take
    element at floor(n_valid * pct) clamped to n_valid-1
    (spectral_flux.rs:163-170, hfc.rs:160-167)."""
    s = masked_sort(x, mask)
    n_valid = jnp.sum(mask, axis=-1)
    idx = jnp.clip((n_valid.astype(jnp.float32) * pct).astype(jnp.int32), 0, jnp.maximum(n_valid - 1, 0))
    return jnp.take_along_axis(s, idx[..., None], axis=-1)[..., 0]


def masked_median(x: jax.Array, mask: jax.Array) -> jax.Array:
    """Median as the reference computes it for frame-energy weighting
    (lib.rs:1257-1260): sort ascending, take element [n/2] (no averaging)."""
    s = masked_sort(x, mask)
    n_valid = jnp.sum(mask, axis=-1)
    idx = jnp.clip(n_valid // 2, 0, jnp.maximum(n_valid - 1, 0))
    return jnp.take_along_axis(s, idx[..., None], axis=-1)[..., 0]


def median_filter_1d(x: jax.Array, half: int) -> jax.Array:
    """Centered median filter on the last axis with *true* edge shrinking.

    Matches the reference's median filters (hpss.rs:179-243,
    smoothing.rs:37-94, extractor.rs:1429-1471): the window is
    [i-half, i+half] clipped to the array; proper even/odd median semantics
    are handled per call site. This generic version computes the median over
    the clipped window using the stack-of-shifts + sort approach (window sizes
    are small: 2*half+1 <= 41).

    Returns (median_odd, sorted_stack, counts) is overkill — we return the
    reference's *interior* median (odd window), and handle edges by median of
    the shrunk window using +/-inf padding with count-aware indexing.
    """
    n = x.shape[-1]
    window = 2 * half + 1
    # Build stacked shifted views with +inf out-of-range so they sort last.
    shifts = []
    for off in range(-half, half + 1):
        idx = jnp.arange(n) + off
        valid = (idx >= 0) & (idx < n)
        g = jnp.take(x, jnp.clip(idx, 0, n - 1), axis=-1)
        shifts.append(jnp.where(valid, g, jnp.inf))
    stack = jnp.stack(shifts, axis=-1)  # [..., n, window]
    s = jnp.sort(stack, axis=-1)
    idx0 = jnp.arange(n)
    cnt = jnp.minimum(idx0 + half, n - 1) - jnp.maximum(idx0 - half, 0) + 1  # [n]
    # Median with reference semantics: even count -> average the two middle
    # values (hpss.rs:196-201); odd count -> middle element.
    mid_hi = cnt // 2
    mid_lo = jnp.where(cnt % 2 == 0, mid_hi - 1, mid_hi)
    bshape = s.shape[:-2]
    mid_hi_b = jnp.broadcast_to(mid_hi, bshape + (n,))
    mid_lo_b = jnp.broadcast_to(mid_lo, bshape + (n,))
    v_hi = jnp.take_along_axis(s, mid_hi_b[..., None], axis=-1)[..., 0]
    v_lo = jnp.take_along_axis(s, mid_lo_b[..., None], axis=-1)[..., 0]
    return 0.5 * (v_hi + v_lo)


def masked_median_filter_1d(x: jax.Array, n_valid: jax.Array, half: int) -> jax.Array:
    """Centered median filter on the last axis with the window clipped to the
    per-row *valid* range [0, n_valid) (reference hpss.rs:179-243 semantics:
    even-count windows average the two middle values). ``n_valid`` broadcasts
    against ``x[..., 0]``. Entries at i >= n_valid are returned unchanged.
    """
    n = x.shape[-1]
    nv = jnp.asarray(n_valid)[..., None]  # [..., 1]
    idx = jnp.arange(n)
    shifts = []
    for off in range(-half, half + 1):
        j = idx + off
        ok = (j >= 0) & (j[None, ...] < nv)
        g = jnp.take(x, jnp.clip(j, 0, n - 1), axis=-1)
        shifts.append(jnp.where(ok, g, jnp.inf))
    stack = jnp.stack(shifts, axis=-1)  # [..., n, window]
    s = jnp.sort(stack, axis=-1)
    lo = jnp.maximum(idx - half, 0)
    hi = jnp.minimum(idx + half, nv - 1)
    cnt = jnp.maximum(hi - lo + 1, 1)  # [..., n]
    mid_hi = cnt // 2
    mid_lo = jnp.where(cnt % 2 == 0, mid_hi - 1, mid_hi)
    tgt = s.shape[:-1]
    v_hi = jnp.take_along_axis(s, jnp.broadcast_to(mid_hi, tgt)[..., None], axis=-1)[..., 0]
    v_lo = jnp.take_along_axis(s, jnp.broadcast_to(mid_lo, tgt)[..., None], axis=-1)[..., 0]
    med = 0.5 * (v_hi + v_lo)
    return jnp.where(idx < nv, med, x)


def median_filter_1d_select_nth(x: jax.Array, half: int) -> jax.Array:
    """Median filter with the reference's ``select_nth_unstable`` semantics
    (single element at index len/2, no even-count averaging) — used by the
    key-only HPSS median mask (extractor.rs:1430-1438)."""
    n = x.shape[-1]
    shifts = []
    for off in range(-half, half + 1):
        idx = jnp.arange(n) + off
        valid = (idx >= 0) & (idx < n)
        g = jnp.take(x, jnp.clip(idx, 0, n - 1), axis=-1)
        shifts.append(jnp.where(valid, g, jnp.inf))
    stack = jnp.stack(shifts, axis=-1)
    s = jnp.sort(stack, axis=-1)
    idx0 = jnp.arange(n)
    cnt = jnp.minimum(idx0 + half, n - 1) - jnp.maximum(idx0 - half, 0) + 1
    mid = cnt // 2
    mid_b = jnp.broadcast_to(mid, s.shape[:-2] + (n,))
    return jnp.take_along_axis(s, mid_b[..., None], axis=-1)[..., 0]


def distance_to_nearest_true(mask: jax.Array, big: float = 1e9) -> jax.Array:
    """For each index i on the last axis, distance (in indices) to the nearest
    True entry. Uses forward/backward min-plus associative scans (log-depth instead
    of a sequential loop)."""
    n = mask.shape[-1]
    d0 = jnp.where(mask, 0.0, big)

    def combine(a, b):
        # running distance: d_out = min(b, a + steps_between) — with unit steps
        # encoded by scanning over (value, offset) pairs
        av, ac = a
        bv, bc = b
        return jnp.minimum(av + bc, bv), ac + bc

    ones = jnp.ones_like(d0)
    fwd, _ = jax.lax.associative_scan(combine, (d0, ones), axis=-1)
    d0r = jnp.flip(d0, axis=-1)
    bwd_r, _ = jax.lax.associative_scan(combine, (d0r, ones), axis=-1)
    bwd = jnp.flip(bwd_r, axis=-1)
    return jnp.minimum(fwd, bwd)


def greedy_dedup_sorted(values: jax.Array, valid: jax.Array, tol: float) -> jax.Array:
    """Greedy dedup over ascending-sorted values: keep entry i iff
    value[i] - value[last_kept] >= tol (reference tempogram.rs:561-570).

    Returns a boolean keep-mask. Invalid entries are never kept. Implemented
    as a small lax.scan along the last axis (entry counts are a few hundred).
    """

    def step(last_kept, inp):
        v, ok = inp
        keep = ok & ((v - last_kept) >= tol)
        new_last = jnp.where(keep, v, last_kept)
        return new_last, keep

    init = jnp.full(values.shape[:-1], -jnp.inf, dtype=values.dtype)
    vt = jnp.moveaxis(values, -1, 0)
    mt = jnp.moveaxis(valid, -1, 0)
    _, keeps = jax.lax.scan(step, init, (vt, mt), unroll=16)
    return jnp.moveaxis(keeps, 0, -1)


def top_k_masked(x: jax.Array, mask: jax.Array, k: int, fill: float = -jnp.inf):
    """top_k over the last axis counting only masked entries.

    Returns (values, indices); slots beyond the number of valid entries get
    ``fill`` values (callers must mask on values > fill)."""
    vals, idx = jax.lax.top_k(jnp.where(mask, x, fill), k)
    return vals, idx
