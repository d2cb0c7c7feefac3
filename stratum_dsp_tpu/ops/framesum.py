"""Blocked frame-sum primitives for sample-domain frame features.

A full-resolution ``jnp.cumsum`` over ``[B, ~8M]`` samples lowers to
O(log T) passes over device memory (the silence and energy-flux stages
would each pay them). Frame grids used by the pipeline always have
``frame_size % hop == 0``, so every frame boundary is a multiple of
``gcd(hop, frame_size)``: one block-sum pass plus a prefix over the tiny
``[B, T/blk]`` block axis yields every frame sum exactly.

Exactness: the batch contract zero-pads beyond each track's ``lengths``
(enforced by the preprocessing masks), so an *unclamped* block-aligned
range sum equals the reference's end-clamped sum (the clamped tail reads
only zeros). Reference frame grids: ``silence.rs:144-169``,
``energy_flux.rs:105-131``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def block_prefix_sumsq(samples: jax.Array, blk: int) -> jax.Array:
    """Exclusive prefix sums of x^2 over ``blk``-sized blocks.

    Returns ``c [B, nb+1]`` with ``c[i] = sum(x[: i*blk] ** 2)``.
    """
    b, t = samples.shape
    nb = -(-t // blk)
    pad = nb * blk - t
    x = jnp.pad(samples, ((0, 0), (0, pad))) if pad else samples
    bs = jnp.sum((x * x).reshape(b, nb, blk), axis=-1)
    c = jnp.cumsum(bs, axis=-1)
    return jnp.concatenate([jnp.zeros((b, 1), c.dtype), c], axis=-1)


def frame_sumsq(
    samples: jax.Array, frame_size: int, hop: int, nf: int
) -> jax.Array:
    """Sum of squares over frames ``[i*hop, i*hop + frame_size)`` for
    ``i in [0, nf)`` — one block-sum pass, no per-sample cumsum.

    Frames that extend past the padded buffer read zeros (matching the
    reference's end clamp given zero padding).
    """
    blk = math.gcd(hop, frame_size)
    c = block_prefix_sumsq(samples, blk)
    nb = c.shape[1] - 1
    si = np.minimum(np.arange(nf, dtype=np.int64) * (hop // blk), nb)
    ei = np.minimum(si + frame_size // blk, nb)
    return c[:, ei] - c[:, si]
