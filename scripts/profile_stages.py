#!/usr/bin/env python
"""Per-stage cumulative timing of the full pipeline on the real device.

Times analyze_batch_arrays truncated at each debug_stop_after cut point;
differences between consecutive cut points give per-stage cost. Prints a
table plus JSON. Usage:

  python scripts/profile_stages.py [--batch 8] [--reps 3] [--seconds 180]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SR = 44100

STAGES = ["onsets", "legacy", "multires", "bpm_select", "grid", ""]
LABELS = {
    "onsets": "preproc+onsets",
    "legacy": "+legacy BPM",
    "multires": "+tempogram+multires",
    "bpm_select": "+perc+fusion",
    "grid": "+beat grid",
    "": "+key (full)",
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--ambiguous", type=float, default=1.0,
                    help="fraction of tracks with BPM in the 55-80 trap zone")
    args = ap.parse_args()

    from stratum_dsp_tpu import compile_cache
    compile_cache.enable()

    import jax

    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps, analyze_batch_arrays
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.testing import kick_pattern

    cfg = AnalysisConfig()
    caps = PipelineCaps()

    t = int(args.seconds * SR)
    n_amb = int(round(args.batch * args.ambiguous))
    # ambiguous: trap-zone (55-80); unambiguous: safely mid-range
    bpms = np.concatenate([
        np.linspace(56.0, 79.0, n_amb) if n_amb else np.zeros((0,)),
        np.linspace(100.0, 150.0, args.batch - n_amb) if args.batch > n_amb else np.zeros((0,)),
    ])
    samples = np.stack([kick_pattern(b, args.seconds) for b in bpms]).astype(np.float32)
    lengths = np.full((args.batch,), t, np.int32)

    fn = jax.jit(
        analyze_batch_arrays,
        static_argnames=("cfg", "sample_rate", "caps", "debug_stop_after"),
    )
    sj = jax.device_put(samples)
    lj = jax.device_put(lengths)

    rows = []
    prev = 0.0
    for stage in STAGES:
        s0 = sj
        t0 = time.time()
        out = fn(s0, lj, cfg=cfg, sample_rate=SR, caps=caps, debug_stop_after=stage)
        jax.block_until_ready(out)
        compile_s = time.time() - t0
        reps_in = [sj] * args.reps
        t0 = time.time()
        for s_r in reps_in:
            out = fn(s_r, lj, cfg=cfg, sample_rate=SR, caps=caps, debug_stop_after=stage)
            jax.block_until_ready(out)
        cum = (time.time() - t0) / args.reps
        rows.append({
            "stage": LABELS[stage], "cumulative_s": round(cum, 4),
            "delta_s": round(cum - prev, 4), "compile_s": round(compile_s, 1),
        })
        prev = cum
        print(f"{LABELS[stage]:24s} cum={cum:7.4f}s  delta={rows[-1]['delta_s']:7.4f}s  (compile {compile_s:.1f}s)", flush=True)

    total = rows[-1]["cumulative_s"]
    print(json.dumps({"batch": args.batch, "total_s": total,
                      "tracks_per_s": round(args.batch / total, 2), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
