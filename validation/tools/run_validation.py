"""Accuracy validation runner (mirror of reference
``validation/tools/run_validation.py``).

Reads a ground-truth CSV (columns: file, bpm[, key]), analyzes every track
through the batched pipeline, and reports ±2/±5/±10 BPM accuracy, MAE, and
exact key accuracy — against the CSV GT and, when available, against ID3
TBPM/TKEY tags (the Mixed-In-Key baseline in the reference's reports).

Resumable: per-track results append to ``--out`` as each device batch
finishes (the reference's harness persists per-run CSVs incrementally,
validation/README.md:173-195); ``--resume`` skips tracks already present in
the output CSV and re-scores the union at the end.

Decode overlaps analysis: while the device analyzes batch N, a host thread
decodes batch N+1 (the reference overlaps via its rayon/thread pools).

Usage:
    python -m validation.tools.run_validation batch.csv [--out results.csv]
        [--batch-size 8] [--limit N] [--resume] [-- <analysis flags>]
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import threading
import time
from pathlib import Path
from queue import Queue

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

# Persistent compile cache.
from stratum_dsp_tpu import compile_cache  # noqa: E402

compile_cache.enable()

from stratum_dsp_tpu.analysis import PipelineCaps, analyze_batch, decode_results  # noqa: E402
from stratum_dsp_tpu.analysis.debug import emit_debug_dump  # noqa: E402
from stratum_dsp_tpu.cli.args import add_config_flags, config_from_args  # noqa: E402
from stratum_dsp_tpu.io.decode import decode_batch  # noqa: E402
from validation._id3 import read_tag_bpm_key  # noqa: E402
from validation._keys import keys_equal, parse_key  # noqa: E402

SR = 44100
BUCKETS = (36.0, 60.0, 120.0, 240.0, 420.0)

RESULT_FIELDS = [
    "file", "error", "bpm", "bpm_confidence", "key", "key_confidence",
    "key_clarity", "grid_stability", "multi_res_used", "gt_bpm", "bpm_err",
    "gt_key", "key_ok", "tempogram_candidates", "beats", "downbeats",
]


def bucket_for(n: int) -> int:
    secs = n / SR
    for b in BUCKETS:
        if secs <= b:
            return int(b * SR)
    return int(BUCKETS[-1] * SR)


def load_batch_csv(path: str, limit: int = 0):
    rows = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            rows.append(row)
    if limit:
        rows = rows[:limit]
    return rows


def load_done(out_path: str) -> dict:
    """Previously-written per-track records keyed by file path (--resume)."""
    done = {}
    p = Path(out_path)
    if not p.exists():
        return done
    with open(p, newline="") as f:
        for rec in csv.DictReader(f):
            if rec.get("file"):
                done[rec["file"]] = rec
    return done


def make_chunks(rows, done, batch_size):
    """Bucket undone tracks by padded length; yields lists of row indices."""
    pending = [i for i, r in enumerate(rows) if r["file"] not in done]
    chunks = []
    groups: dict[int, list[int]] = {}
    # bucket key needs the decoded length; defer bucketing to decode time by
    # chunking on file order first, then splitting each decoded chunk by
    # bucket. Simpler: fixed-size chunks in file order (decode tells length).
    for s in range(0, len(pending), batch_size):
        chunks.append(pending[s : s + batch_size])
    return chunks


def score_records(rows, records_by_file):
    n_bpm, hit2, hit5, hit10, abs_err = 0, 0, 0, 0, []
    n_key, key_hits = 0, 0
    tag_n_bpm, tag_hit2 = 0, 0
    tag_n_key, tag_key_hits = 0, 0
    analyzed = 0
    for row in rows:
        rec = records_by_file.get(row["file"])
        if rec is None or rec.get("error"):
            continue
        analyzed += 1
        gt_bpm = float(row["bpm"]) if row.get("bpm") else None
        if gt_bpm and gt_bpm > 0:
            n_bpm += 1
            d = abs(float(rec["bpm"]) - gt_bpm)
            abs_err.append(d)
            hit2 += d <= 2.0
            hit5 += d <= 5.0
            hit10 += d <= 10.0
        gt_key = parse_key(row.get("key", "") or "")
        if gt_key is not None and rec.get("key"):
            pred = parse_key(rec["key"])
            if pred is not None:
                n_key += 1
                key_hits += keys_equal(pred, gt_key)
        tag_bpm, tag_key_raw = read_tag_bpm_key(row["file"])
        if gt_bpm and tag_bpm:
            tag_n_bpm += 1
            tag_hit2 += abs(tag_bpm - gt_bpm) <= 2.0
        tk = parse_key(tag_key_raw or "")
        if gt_key is not None and tk is not None:
            tag_n_key += 1
            tag_key_hits += keys_equal(tk, gt_key)
    return {
        "tracks": len(rows),
        "analyzed": analyzed,
        "bpm_acc_2": round(hit2 / n_bpm, 4) if n_bpm else None,
        "bpm_acc_5": round(hit5 / n_bpm, 4) if n_bpm else None,
        "bpm_acc_10": round(hit10 / n_bpm, 4) if n_bpm else None,
        "bpm_mae": round(float(np.mean(abs_err)), 3) if abs_err else None,
        "key_acc": round(key_hits / n_key, 4) if n_key else None,
        "tag_bpm_acc_2": round(tag_hit2 / tag_n_bpm, 4) if tag_n_bpm else None,
        "tag_key_acc": round(tag_key_hits / tag_n_key, 4) if tag_n_key else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("batch_csv")
    p.add_argument("--out", default=None, help="per-track results CSV (appended incrementally)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="skip tracks already present in --out")
    p.add_argument("--no-pad-batches", dest="pad_batches", action="store_false",
                   help="don't zero-pad partial sub-batches to --batch-size "
                        "(padding bounds jit shapes to one per bucket)")
    p.add_argument("--emit-candidates", action="store_true")
    p.add_argument("--emit-beats", action="store_true",
                   help="write per-track beat/downbeat times (JSON lists, "
                        "ORIGINAL-track seconds: predicted time + leading "
                        "trim offset) into the results CSV for grid scoring")
    add_config_flags(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    if args.emit_candidates:
        cfg = cfg.replace(emit_tempogram_candidates=True)

    rows = load_batch_csv(args.batch_csv, args.limit)
    done = load_done(args.out) if (args.resume and args.out) else {}
    if done:
        print(f"resuming: {len(done)} tracks already in {args.out}", file=sys.stderr)
    chunks = make_chunks(rows, done, args.batch_size)
    n_pending = sum(len(c) for c in chunks)
    print(f"validating {n_pending}/{len(rows)} tracks", file=sys.stderr)

    out_f = None
    writer = None
    if args.out:
        exists = Path(args.out).exists() and args.resume
        out_f = open(args.out, "a" if exists else "w", newline="")
        writer = csv.DictWriter(out_f, fieldnames=RESULT_FIELDS, extrasaction="ignore")
        if not exists:
            writer.writeheader()

    # decode pipeline: a host thread decodes chunk k+1 while the device
    # analyzes chunk k
    decode_q: Queue = Queue(maxsize=2)

    def decoder():
        for chunk in chunks:
            paths = [rows[i]["file"] for i in chunk]
            decode_q.put((chunk, decode_batch(paths, target_sr=SR)))
        decode_q.put(None)

    threading.Thread(target=decoder, daemon=True).start()

    records_by_file = dict(done)
    caps = PipelineCaps()
    t0 = time.time()
    n_done = 0
    while True:
        item = decode_q.get()
        if item is None:
            break
        chunk, decoded = item
        # split by bucketed padded length so jit shapes stay bounded
        sub: dict[int, list[int]] = {}
        new_recs = []
        for j, (samples, _sr, err) in enumerate(decoded):
            i = chunk[j]
            if err is not None or samples is None or samples.size == 0:
                new_recs.append({"file": rows[i]["file"], "error": err or "empty"})
                continue
            sub.setdefault(bucket_for(len(samples)), []).append(j)
        for bucket_len, js in sorted(sub.items()):
            # pad partial sub-batches with zero-length dummy tracks so each
            # bucket compiles exactly ONE (batch_size, bucket_len) program;
            # the pipeline zero-masks lengths==0 (pipeline.py track_ok)
            nb = args.batch_size if args.pad_batches else len(js)
            batch = np.zeros((nb, bucket_len), np.float32)
            lengths = np.zeros((nb,), np.int32)
            for k, j in enumerate(js):
                x = decoded[j][0][:bucket_len]
                batch[k, : len(x)] = x
                lengths[k] = len(x)
            out = analyze_batch(batch, lengths, cfg, SR, caps)
            results = decode_results(out, SR)
            for k, j in enumerate(js):
                i = chunk[j]
                if cfg.debug_track_id is not None:
                    emit_debug_dump(out, cfg, k, gt_bpm=float(rows[i].get("bpm") or 0) or None)
                r = results[k]
                rec = {
                    "file": rows[i]["file"],
                    "bpm": round(r.bpm, 2),
                    "bpm_confidence": round(r.bpm_confidence, 4),
                    "key": r.key.name(),
                    "key_confidence": round(r.key_confidence, 4),
                    "key_clarity": round(r.key_clarity, 4),
                    "grid_stability": round(r.grid_stability, 4),
                    "multi_res_used": r.metadata.tempogram_multi_res_used,
                }
                gt_bpm = float(rows[i]["bpm"]) if rows[i].get("bpm") else None
                if gt_bpm and gt_bpm > 0:
                    rec["gt_bpm"] = gt_bpm
                    rec["bpm_err"] = round(abs(r.bpm - gt_bpm), 2)
                gt_key = parse_key(rows[i].get("key", "") or "")
                if gt_key is not None:
                    rec["gt_key"] = gt_key.name()
                    rec["key_ok"] = keys_equal(r.key, gt_key)
                if args.emit_beats:
                    trim = float(np.asarray(out["trim_start_seconds"])[k])
                    rec["beats"] = json.dumps(
                        [round(t + trim, 4) for t in r.beat_grid.beats]
                    )
                    rec["downbeats"] = json.dumps(
                        [round(t + trim, 4) for t in r.beat_grid.downbeats]
                    )
                if r.metadata.tempogram_candidates is not None:
                    rec["tempogram_candidates"] = json.dumps(
                        [
                            {"bpm": round(c.bpm, 2), "score": round(c.score, 4),
                             "selected": c.selected}
                            for c in r.metadata.tempogram_candidates
                        ]
                    )
                new_recs.append(rec)
        for rec in new_recs:
            records_by_file[rec["file"]] = rec
            if writer is not None:
                writer.writerow(rec)
        if out_f is not None:
            out_f.flush()
        n_done += len(chunk)
        print(f"  {n_done}/{n_pending} analyzed ({time.time()-t0:.0f}s)", file=sys.stderr)

    wall = time.time() - t0
    summary = score_records(rows, records_by_file)
    summary["wall_s"] = round(wall, 1)
    summary["tracks_per_sec"] = round(n_done / max(wall, 1e-9), 2)
    print(json.dumps(summary, indent=2))
    if out_f is not None:
        out_f.close()
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
