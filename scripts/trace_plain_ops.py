#!/usr/bin/env python
"""Device time of the plain XLA formulations that replaced hand-written
kernels, each traced in isolation at the pipeline's B=40 x 180 s shapes,
beside one traced B=40 batch of the full pipeline.

The pipeline runs its kernels inside CUDA command buffers, which the trace
does not attribute to source ops, so each formulation is jitted and traced
on its own: its device busy time over the window, divided by the number of
calls, is its time per batch.

Usage: python scripts/trace_plain_ops.py [--out DIR] [--autotune-probe]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SR = 44100
SECONDS = 180.0
B = 40


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="traces/plain")
    ap.add_argument("--autotune-probe", action="store_true",
                    help="also compile the pipeline with xla_gpu_autotune_level=0 "
                         "and report compile and batch time")
    args = ap.parse_args()

    from stratum_dsp_tpu import compile_cache

    compile_cache.enable()
    import jax
    import jax.numpy as jnp

    import bench
    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps, analyze_batch_arrays
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.beat import hmm
    from stratum_dsp_tpu.features.beat.grid import detect_downbeats
    from stratum_dsp_tpu.features.key.pipeline import _key_keep_bins
    from stratum_dsp_tpu.features.period import novelty as nov
    from stratum_dsp_tpu.ops import stft
    from stratum_dsp_tpu.testing import kick_pattern_device

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 2
    print(bench.gpu_name_and_power()[0], flush=True)
    cfg, caps = AnalysisConfig(), PipelineCaps()
    bpms, _ = bench.bench_mixes(B)
    x = jax.jit(lambda v: kick_pattern_device(v, SECONDS))(bpms.astype(np.float32))
    lens = jnp.full((B,), int(SECONDS * SR), jnp.int32)
    rng = np.random.default_rng(0)
    mb = caps.max_beats
    times = jnp.asarray(np.sort(rng.uniform(0, SECONDS, (B, mb)), axis=-1).astype(np.float32))
    n_beats = jnp.full((B,), 360, jnp.int32)
    emis = jnp.asarray(rng.uniform(0.01, 1.0, (B, mb)).astype(np.float32))

    def stft_sum(frame, hop, keep):
        def f(s, ln):
            outs, _, _ = stft.stft_reduce(
                s, ln, frame, hop, lambda sp, fi, fv, c: ({"e": jnp.sum(sp, -1)}, c),
                lambda b: jnp.zeros((b,)), chunk_frames=256, keep_bins=keep,
                bf16=cfg.stft_bf16,
            )
            return jnp.sum(outs["e"])
        return jax.jit(f)

    key_keep = _key_keep_bins(cfg, SR, cfg.key_stft_frame_size)
    # the same jit as bench.py and chip_smoke.py, so the persistent cache hits
    fnp = jax.jit(analyze_batch_arrays, static_argnames=("cfg", "sample_rate", "caps"))
    cases = {
        "full_pipeline": (lambda s, ln: fnp(s, ln, cfg=cfg, sample_rate=SR, caps=caps), (x, lens)),
        "key_stft_polyphase_8192": (stft_sum(cfg.key_stft_frame_size, cfg.key_stft_hop_size, key_keep), (x, lens)),
        "bpm_stft_rfft_2048": (stft_sum(cfg.frame_size, cfg.hop_size, None), (x, lens)),
        "bpm_frontend_novelty": (jax.jit(lambda s, ln: nov.compute_bpm_spectral_features(
            s, ln, cfg, SR, cfg.frame_size, cfg.hop_size, caps.chunk_frames)[0]["superflux"]), (x, lens)),
        "downbeat_walk": (jax.jit(lambda t, n, b: detect_downbeats(t, n, b, jnp.zeros_like(n))),
                          (times, n_beats, jnp.asarray(bpms.astype(np.float32)))),
        "viterbi_scan": (jax.jit(hmm.viterbi_decode), (emis,)),
    }
    reps = 3
    res = {}
    for name, (fn, a) in cases.items():
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        first = time.perf_counter() - t0
        jax.block_until_ready(fn(*a))
        d = os.path.join(args.out, name)
        with jax.profiler.trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*a))
        summ = next(iter(bench.device_trace_summary(d, top=12).values()))
        res[name] = {
            "first_call_s": first,
            "device_busy_ms_per_call": summ["busy_ms"] / reps,
            "window_ms_per_call": summ["window_ms"] / reps,
            "idle_share": summ["idle_share"],
            "kernels_per_call": summ["n_kernels"] / reps,
            "top_kernels_ms_per_call": [(n, t / reps) for n, t in summ["top_kernels_ms"]],
        }
        print(json.dumps({name: res[name]}), flush=True)
    full = res["full_pipeline"]["device_busy_ms_per_call"]
    print(json.dumps({"share_of_full_batch_busy": {
        k: v["device_busy_ms_per_call"] / full for k, v in res.items() if k != "full_pipeline"}}))

    if args.autotune_probe:
        t0 = time.perf_counter()
        comp = fnp.lower(x, lens, cfg=cfg, sample_rate=SR, caps=caps).compile(
            compiler_options={"xla_gpu_autotune_level": 0})
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(comp(x, lens))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(comp(x, lens))
            ts.append(time.perf_counter() - t0)
        print(json.dumps({"autotune_level_0": {"compile_s": compile_s,
                                               "batch_s_median": float(np.median(ts))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
