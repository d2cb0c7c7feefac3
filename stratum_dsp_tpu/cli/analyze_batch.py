"""Batch analysis CLI — the throughput path.

Mirror of the reference's ``analyze_batch`` example
(examples/analyze_batch.rs): many files -> JSONL, with a wall-clock /
throughput summary. Unlike the reference's rayon thread pool over
single-threaded analyses, this pipeline is batch-first: the native decode
pool fills padded ``[B, T]`` buckets that run through one jitted device
program per bucket shape.

Usage: python -m stratum_dsp_tpu.cli.analyze_batch tracks/*.wav -o out.jsonl
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import threading
import time
from pathlib import Path
from queue import Queue

import numpy as np

from ..analysis import PipelineCaps, analyze_batch, decode_results
from ..io.decode import MIX_AVERAGE, decode_batch
from .args import add_config_flags, config_from_args

# Bucket boundaries (seconds) to bound padding waste; tracks land in the
# smallest bucket that fits, longest are truncated to the max bucket.
DEFAULT_BUCKETS = (60.0, 120.0, 240.0, 420.0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Analyze a batch of audio files (JSONL out)")
    p.add_argument("paths", nargs="+", help="audio files")
    p.add_argument("-o", "--output", default="-", help="JSONL output path (default stdout)")
    p.add_argument("--batch-size", type=int, default=40,
                   help="tracks per device batch (40: untuned on the H100)")
    p.add_argument("--target-sample-rate", type=int, default=44100)
    p.add_argument("--decode-threads", type=int, default=0, help="0 = CPU count - 1")
    p.add_argument("--max-onsets", type=int, default=2048)
    p.add_argument("--max-beats", type=int, default=1024)
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: stage INFO logs, -vv: DEBUG batch summaries")
    p.add_argument("--debug-nans", action="store_true",
                   help="dev mode: raise on any NaN produced under jit "
                        "(jax_debug_nans; SURVEY §5 jit-purity checks)")
    add_config_flags(p)
    return p


def bucket_for(n_samples: int, sr: int, buckets=DEFAULT_BUCKETS) -> int:
    secs = n_samples / sr
    for b in buckets:
        if secs <= b:
            return int(b * sr)
    return int(buckets[-1] * sr)


def main(argv=None) -> int:
    from .. import compile_cache

    compile_cache.enable()
    args = build_parser().parse_args(argv)
    if args.verbose:
        logging.basicConfig(
            level=logging.DEBUG if args.verbose > 1 else logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
            stream=sys.stderr,
        )
        logging.getLogger("stratum_dsp_tpu").setLevel(
            logging.DEBUG if args.verbose > 1 else logging.INFO
        )
    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)
    cfg = config_from_args(args)
    caps = PipelineCaps(max_onsets=args.max_onsets, max_beats=args.max_beats)
    sr = args.target_sample_rate

    out_fh = sys.stdout if args.output == "-" else open(args.output, "w")
    t_start = time.time()

    # decode/analyze overlap: a host thread decodes chunk k+1 while the
    # device analyzes chunk k (the reference's rayon pool analogue with the
    # device as the consumer)
    chunks = [
        list(range(i, min(i + args.batch_size, len(args.paths))))
        for i in range(0, len(args.paths), args.batch_size)
    ]
    decode_q: Queue = Queue(maxsize=2)

    def decoder():
        for chunk in chunks:
            paths = [args.paths[i] for i in chunk]
            decode_q.put(
                (chunk, decode_batch(paths, target_sr=sr, n_threads=args.decode_threads))
            )
        decode_q.put(None)

    threading.Thread(target=decoder, daemon=True).start()

    from ..analysis.timing import analyze_batch_timed

    n_ok = 0
    while True:
        item = decode_q.get()
        if item is None:
            break
        chunk, decoded = item
        # split by padded bucket length so jit shapes stay bounded
        sub: dict[int, list[int]] = {}
        for j, (samples, _sr, err) in enumerate(decoded):
            if err is not None or samples is None or samples.size == 0:
                rec = {"file": args.paths[chunk[j]], "error": err or "empty audio"}
                out_fh.write(json.dumps(rec) + "\n")
                continue
            sub.setdefault(bucket_for(len(samples), sr), []).append(j)
        for bucket_len, js in sorted(sub.items()):
            b = len(js)
            batch = np.zeros((b, bucket_len), np.float32)
            lengths = np.zeros((b,), np.int32)
            for k, j in enumerate(js):
                s = decoded[j][0][:bucket_len]
                batch[k, : len(s)] = s
                lengths[k] = len(s)
            out = analyze_batch_timed(batch, lengths, cfg, sr, caps)
            results = decode_results(out, sr)
            for k, j in enumerate(js):
                rec = {"file": args.paths[chunk[j]], **results[k].to_dict()}
                out_fh.write(json.dumps(rec) + "\n")
                n_ok += 1

    wall = time.time() - t_start
    print(
        f"analyzed {n_ok}/{len(args.paths)} tracks in {wall:.1f}s "
        f"({n_ok / max(wall, 1e-9):.2f} tracks/sec)",
        file=sys.stderr,
    )
    if out_fh is not sys.stdout:
        out_fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
