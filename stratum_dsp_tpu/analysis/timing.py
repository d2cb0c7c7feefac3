"""Stage-boundary observability: logging, wall timings, per-stage profiling.

Batch-shaped equivalent of the reference's per-stage ``log::debug`` lines and
``processing_time_ms`` stamping (lib.rs:91-92, 700-706, 1603;
tempogram.rs:720-755). Everything under ``jit`` is traced once, so per-call
Python logging inside the pipeline is impossible; instead:

* ``analyze_batch_timed`` wraps the jitted pipeline call with wall-clock
  timing, stamps ``processing_time_ms`` into the result dict, and logs a
  host-side batch summary (escalation/fallback/warning counts) at DEBUG —
  the batch analogue of the reference's per-decision stderr lines.
* ``stage_timings`` measures cumulative per-stage device time by running the
  pipeline truncated at each ``debug_stop_after`` boundary (XLA dead-code
  eliminates everything after the returned stage, so each measurement is the
  true cost of the prefix). Differences give per-stage costs without any
  per-dispatch overhead pollution.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AnalysisConfig
from .pipeline import PipelineCaps, analyze_batch_arrays

logger = logging.getLogger("stratum_dsp_tpu")

STAGES = ("onsets", "legacy", "multires", "bpm_select", "grid", "")


def _jit_pipeline():
    return jax.jit(
        analyze_batch_arrays,
        static_argnames=("cfg", "sample_rate", "caps", "debug_stop_after"),
    )


def analyze_batch_timed(
    samples,
    lengths,
    cfg: AnalysisConfig = AnalysisConfig(),
    sample_rate: int = 44100,
    caps: PipelineCaps = PipelineCaps(),
) -> Dict[str, jax.Array]:
    """Jitted full pipeline + wall timing + batch-summary DEBUG log.

    Adds ``processing_time_ms`` [B] (per-track share of the batch wall time,
    the batch analogue of lib.rs:91-92) to the result dict.
    """
    samples = jnp.asarray(samples, jnp.float32)
    lengths = jnp.asarray(lengths, jnp.int32)
    b = samples.shape[0]
    t0 = time.time()
    fn = _jit_pipeline()
    out = dict(
        fn(samples, lengths, cfg=cfg, sample_rate=sample_rate, caps=caps)
    )
    jax.block_until_ready(out)
    dt_ms = (time.time() - t0) * 1e3
    out["processing_time_ms"] = jnp.full((b,), np.float32(dt_ms / max(b, 1)))

    if logger.isEnabledFor(logging.DEBUG):
        mr_t = int(np.sum(np.asarray(out["multi_res_triggered"])))
        mr_u = int(np.sum(np.asarray(out["multi_res_used"])))
        pc_u = int(np.sum(np.asarray(out["percussive_used"])))
        n_ok = int(np.sum(np.asarray(out["ok"])))
        warn = int(np.sum(np.asarray(out["warn_low_grid_stability"])))
        logger.debug(
            "analyze_batch: b=%d ok=%d wall=%.1fms (%.2fms/track) "
            "multi_res triggered=%d used=%d percussive_used=%d "
            "low_stability=%d",
            b, n_ok, dt_ms, dt_ms / max(b, 1), mr_t, mr_u, pc_u, warn,
        )
    return out


def stage_timings(
    samples,
    lengths,
    cfg: AnalysisConfig = AnalysisConfig(),
    sample_rate: int = 44100,
    caps: PipelineCaps = PipelineCaps(),
    reps: int = 2,
) -> Dict[str, float]:
    """Cumulative + per-stage wall seconds for each pipeline prefix.

    Returns ``{stage: cumulative_s, stage+"_delta": s_since_previous}``.
    """
    samples = jnp.asarray(samples, jnp.float32)
    lengths = jnp.asarray(lengths, jnp.int32)
    fn = _jit_pipeline()

    out: Dict[str, float] = {}
    prev = 0.0
    for stage in STAGES:
        # compile (untimed)
        r = fn(samples, lengths, cfg=cfg, sample_rate=sample_rate, caps=caps,
               debug_stop_after=stage)
        jax.block_until_ready(r)
        times = []
        for _ in range(reps):
            t0 = time.time()
            r = fn(samples, lengths, cfg=cfg, sample_rate=sample_rate, caps=caps,
                   debug_stop_after=stage)
            np.asarray(jax.tree_util.tree_leaves(r)[0])  # host readback
            times.append(time.time() - t0)
        cum = float(np.median(times))
        name = stage or "full"
        out[name] = cum
        out[name + "_delta"] = cum - prev
        prev = cum
        logger.info("stage %-10s cumulative %7.1f ms  delta %7.1f ms",
                    name, cum * 1e3, out[name + "_delta"] * 1e3)
    return out
