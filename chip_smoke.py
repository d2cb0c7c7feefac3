#!/usr/bin/env python
"""End-to-end smoke test of the analysis pipeline on an NVIDIA GPU.

Drives the main path once at the width users run it: default
``AnalysisConfig()`` and ``PipelineCaps()``, 3-minute 44.1 kHz tracks,
B=40. Phases, in order; each raises on failure, and the script then exits
non-zero:

  a. device: JAX must find a GPU (no CPU fallback); prints the card.
  b. served path: 8 encoded 180 s tracks (WAV, one also FLAC) through the
     ``analyze_batch`` and ``analyze_file`` CLIs, checked against the seeds.
  c. batch path: B=40 x 180 s, clean and adversarial mixes, through the
     jitted ``analyze_batch_arrays`` with ``bench.py``'s exact gates.
  d. parity: 12 tracks on the GPU vs the same jitted function on the CPU
     device of this process; key/BPM STFT magnitudes vs float64 numpy.

``--four-cards`` runs only the sharded path and its one-card comparison:
the 1-D ``tracks`` mesh at B=40 x 180 s and the 2-D (tracks=2, time=2)
mesh on 4 x 360 s tracks.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--four-cards]
"""

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import wave

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np

SR = 44100
SECONDS = 180.0
BATCH = 40

# Decision tolerances between two runs of the pipeline (GPU vs CPU, sharded
# vs one card). Key index must match exactly. BPM is quantized by the
# tempogram's 1-BPM grid plus sub-bin refinement, so 0.1 BPM admits only
# summation-order noise in the refinement. Grid stability is 1/(1+CV) of
# beat intervals; 0.02 is far below the 0.5 warning threshold it feeds.
# Beat and downbeat grids: counts within one, or else the shorter grid must
# lie on the longer one (every time within 10 ms of one of its times) and
# miss at most 10% of its times: where a filled grid starts or ends is a
# knife edge of the emission threshold — on the CPU alone, -80 dB of input
# noise moves fullmix_C_86's first beat by 12 beats (5% of its 236) — while
# the lattice itself (tempo, phase, bar phase) is what a platform difference
# would break.
TOLERANCES = {"bpm": 0.1, "count": 1, "lattice_s": 0.010, "missing": 0.10,
              "stability": 0.02}

# Compile flags of this script, appended to XLA_FLAGS unless given there;
# the library, the CLIs and bench.py keep XLA's defaults. The script must
# finish within its time budget, compiles included, and GEMM autotuning is
# about a third of a full-pipeline compile (NVIDIA H100 80GB HBM3, 400 W:
# 209 vs 323 s). The four-card phase compiles four programs side by side,
# so it also splits each program's LLVM code generation across threads.
COMPILE_FLAGS = ("--xla_gpu_autotune_level=0",)
FOUR_CARD_COMPILE_FLAGS = COMPILE_FLAGS + (
    "--xla_gpu_enable_llvm_module_compilation_parallelism=true",
    "--xla_gpu_force_compilation_parallelism=16",
)

# fullmix battery tracks (testing/battery.py) with their ground truth:
# (bpm, tonic, is_major, key name)
FULLMIX = [
    (86.0, 0, True, "C"),
    (94.0, 9, False, "Am"),
    (102.0, 7, True, "G"),
    (110.0, 4, False, "Em"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def decisions(out) -> dict:
    """Per-track decisions from a pipeline result dict, as numpy arrays
    (beat and downbeat times as one array of valid times per track)."""
    def times(key):
        t, v = np.asarray(out[f"{key}_times"]), np.asarray(out[f"{key}_valid"])
        return [ti[vi] for ti, vi in zip(t, v)]

    return {
        "key_idx": np.asarray(out["key_idx"]),
        "bpm": np.asarray(out["bpm"]),
        "beats": times("beat"),
        "downbeats": times("downbeat"),
        "stability": np.asarray(out["grid_stability"]),
    }


def grids_agree(a: np.ndarray, b: np.ndarray, tol: dict = TOLERANCES) -> bool:
    """Beat (or downbeat) grids ``a`` and ``b`` agree: counts within
    ``tol["count"]``, or the shorter one lies on the longer one and misses
    at most ``tol["missing"]`` of its times."""
    if abs(len(a) - len(b)) <= tol["count"]:
        return True
    short, long_ = (a, b) if len(a) < len(b) else (b, a)
    if len(long_) - len(short) > tol["missing"] * len(long_):
        return False
    nearest = np.abs(short[:, None] - long_[None, :]).min(axis=1)
    return bool(np.all(nearest <= tol["lattice_s"]))


def compare_decisions(got: dict, ref: dict, tol: dict = TOLERANCES) -> list:
    """Human-readable list of every track whose decisions differ beyond
    ``tol``; empty when the two runs agree."""
    bad = []
    for i in range(len(ref["bpm"])):
        why = []
        if got["key_idx"][i] != ref["key_idx"][i]:
            why.append(f"key {got['key_idx'][i]} vs {ref['key_idx'][i]}")
        if abs(float(got["bpm"][i]) - float(ref["bpm"][i])) > tol["bpm"]:
            why.append(f"bpm {got['bpm'][i]:.3f} vs {ref['bpm'][i]:.3f}")
        for k in ("beats", "downbeats"):
            if not grids_agree(got[k][i], ref[k][i], tol):
                why.append(f"{k} {len(got[k][i])} vs {len(ref[k][i])} off one lattice")
        if abs(float(got["stability"][i]) - float(ref["stability"][i])) > tol["stability"]:
            why.append(f"stability {got['stability'][i]:.4f} vs {ref['stability'][i]:.4f}")
        if why:
            bad.append(f"track {i}: " + ", ".join(why))
    return bad


def add_compile_flags(flags) -> None:
    """Append ``flags`` to ``XLA_FLAGS``, each unless already set there; XLA
    reads them when the backend starts."""
    have = os.environ.get("XLA_FLAGS", "")
    extra = [f for f in flags if f.split("=")[0] not in have]
    os.environ["XLA_FLAGS"] = " ".join([have, *extra]).strip()


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found {devs[0].platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs; JAX found {len(devs)}")
    import bench

    smi, _, _ = bench.gpu_name_and_power()
    log(f"[a] device_kind={devs[0].device_kind} count={len(devs)} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[a] nvidia-smi: {smi}")
    return devs[0], smi


def _write_wav(path: str, x: np.ndarray) -> np.ndarray:
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    return pcm


def phase_served(data_dir: str) -> None:
    import bench
    from stratum_dsp_tpu.cli import analyze_batch as cli_batch
    from stratum_dsp_tpu.cli import analyze_file as cli_file
    from stratum_dsp_tpu.io import decode
    from stratum_dsp_tpu.testing import kick_pattern
    from stratum_dsp_tpu.testing.battery import fullmix_track
    from stratum_dsp_tpu.testing.flac_writer import write_flac

    if decode.native_lib() is None:
        raise RuntimeError(
            f"native decoder failed to build or load (native/*.cpp): {decode.build_error}")
    t0 = time.perf_counter()
    _, adv = bench.bench_mixes(BATCH)
    kick_bpms = adv[[0, 9, 18, 27]]  # integer core seeds of the bench
    truth = {}
    for bpm in kick_bpms:
        p = os.path.join(data_dir, f"kick_{bpm:g}.wav")
        _write_wav(p, kick_pattern(float(bpm), SECONDS))
        truth[p] = (float(bpm), None)
    for bpm, tonic, major, key in FULLMIX:
        p = os.path.join(data_dir, f"fullmix_{key}_{bpm:g}.wav")
        pcm = _write_wav(p, fullmix_track(f"fullmix_{key}_{bpm:g}bpm", bpm, tonic, major, SECONDS))
        truth[p] = (bpm, key)
    flac = os.path.join(data_dir, f"fullmix_{key}_{bpm:g}.flac")
    write_flac(flac, pcm, SR)
    truth[flac] = (bpm, key)
    log(f"[b] wrote {len(truth)} files ({SECONDS:g} s) in {time.perf_counter() - t0:.1f} s")

    out_path = os.path.join(data_dir, "out.jsonl")
    t0 = time.perf_counter()
    # batches of one at the 240 s bucket: the program analyze_file runs too
    rc = cli_batch.main(list(truth) + ["-o", out_path, "--batch-size", "1"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"analyze_batch exited {rc}")
    with open(out_path) as f:
        recs = [json.loads(line) for line in f]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_file.main([flac, "--json"])
    if rc != 0:
        raise RuntimeError(f"analyze_file exited {rc}")
    recs.append({"file": flac, **json.loads(buf.getvalue().strip().splitlines()[-1])})
    if len(recs) != len(truth) + 1:
        raise RuntimeError(f"{len(recs)} records for {len(truth) + 1} analyses")

    fails = []
    for r in recs:
        bpm, key = truth[r["file"]]
        name = os.path.basename(r["file"])
        log(f"[b] {name}: bpm={r.get('bpm')} key={r.get('key')} "
            f"beats={r.get('beat_count')} downbeats={r.get('downbeat_count')}")
        if "error" in r:
            fails.append(f"{name}: error {r['error']}")
            continue
        if 85.0 <= bpm < 170.0 and abs(r["bpm"] - bpm) > 2.0:
            fails.append(f"{name}: bpm {r['bpm']} vs {bpm}")
        if key is not None and r["key"] != key:
            fails.append(f"{name}: key {r['key']} vs {key}")
        if r["beat_count"] == 0 or r["downbeat_count"] == 0:
            fails.append(f"{name}: empty beat grid")
    if fails:
        raise RuntimeError("served path: " + "; ".join(fails))
    log(f"[b] served path ok: {len(truth)} files via analyze_batch in {wall:.1f} s "
        f"(cold compile included) + analyze_file")


def phase_batch(dev, smi: str):
    import jax

    import bench
    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps, analyze_batch_arrays
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.testing import kick_pattern_device

    cfg, caps = AnalysisConfig(), PipelineCaps()
    bpms, adv = bench.bench_mixes(BATCH)
    synth = jax.jit(lambda v: kick_pattern_device(v, SECONDS))
    lens = jax.device_put(np.full((BATCH,), int(SECONDS * SR), np.int32), dev)
    clean_x = synth(jax.device_put(bpms.astype(np.float32), dev))
    fn = jax.jit(analyze_batch_arrays, static_argnames=("cfg", "sample_rate", "caps"))
    args = dict(cfg=cfg, sample_rate=SR, caps=caps)

    t0 = time.perf_counter()
    compiled = fn.lower(clean_x, lens, **args).compile()
    cold = time.perf_counter() - t0
    jax.clear_caches()
    t0 = time.perf_counter()
    fn.lower(clean_x, lens, **args).compile()
    warm = time.perf_counter() - t0
    log(f"[c] compile: first {cold:.1f} s, again from the persistent cache {warm:.1f} s "
        f"(cache dir {jax.config.jax_compilation_cache_dir})")
    del compiled

    label = f"{dev.device_kind} | {smi}"
    for mix, seeds in (("clean", bpms), ("adversarial", adv)):
        x = clean_x if mix == "clean" else synth(jax.device_put(seeds.astype(np.float32), dev))
        out = fn(x, lens, **args)
        jax.block_until_ready(out)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(x, lens, **args)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        dt = float(np.median(ts))
        exact, core, family = bench.bpm_gates(np.asarray(out["bpm"]), seeds)
        n_esc = int(np.sum(np.asarray(out["multi_res_used"])))
        log(f"[c] {mix}: {dt:.4f} s/batch, {BATCH / dt:.2f} tracks/s, escalated {n_esc}/{BATCH}, "
            f"exact={exact} exact_core={core} family={family} [{label}]")
        ok = exact == 1.0 if mix == "clean" else (core == 1.0 and family == 1.0)
        if not ok:
            raise RuntimeError(f"batch path gate failed on the {mix} mix: "
                               f"{np.asarray(out['bpm']).round(2).tolist()}")
    peak = dev.memory_stats()["peak_bytes_in_use"]
    log(f"[c] peak_bytes_in_use={peak} ({peak / 2**30:.2f} GiB) [{label}]")
    return fn


def _numpy_stft_mag(x: np.ndarray, frame: int, hop: int, keep: int, periodic: bool):
    """float64 |rfft| of Hann-windowed frames, [n_frames, keep]."""
    n = (len(x) - frame) // hop + 1
    i = np.arange(frame)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * i / (frame if periodic else frame - 1))
    out = np.empty((n, keep))
    for s in range(0, n, 512):
        idx = np.arange(s, min(s + 512, n))[:, None] * hop + i[None, :]
        out[s : s + len(idx)] = np.abs(np.fft.rfft(x[idx].astype(np.float64) * w, axis=-1))[:, :keep]
    return out


def phase_parity(dev, fn) -> None:
    """``fn``: phase c's jitted pipeline; the parity batch has phase c's
    shape, so the GPU side reuses its executable."""
    import jax
    import jax.numpy as jnp

    import bench
    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.features.key.pipeline import _key_keep_bins, _key_stft_params
    from stratum_dsp_tpu.ops import stft
    from stratum_dsp_tpu.testing import kick_pattern
    from stratum_dsp_tpu.testing.battery import fullmix_track

    cpu = jax.devices("cpu")[0]
    cfg, caps = AnalysisConfig(), PipelineCaps()
    bpms, adv = bench.bench_mixes(BATCH)
    # 4 clean, 4 adversarial (2 in trap zones) and 4 fullmix tracks, filled
    # up to phase c's batch with the rest of the clean mix
    picked = [3, 14, 25, 36]
    seeds = list(bpms[picked]) + list(adv[[5, 20, 29, 37]])
    seeds += [b for i, b in enumerate(bpms) if i not in picked][: BATCH - 12]
    tracks = [fullmix_track(f"fullmix_{k}_{b:g}bpm", b, t, m, SECONDS) for b, t, m, k in FULLMIX]
    tracks += [kick_pattern(float(b), SECONDS) for b in seeds]
    x = np.stack(tracks).astype(np.float32)
    lens = np.full((len(tracks),), x.shape[1], np.int32)
    res = {}
    for name, d in (("gpu", dev), ("cpu", cpu)):
        t0 = time.perf_counter()
        out = fn(jax.device_put(x, d), jax.device_put(lens, d), cfg=cfg, sample_rate=SR, caps=caps)
        res[name] = decisions(out)
        log(f"[d] {name}: {len(tracks)} tracks in {time.perf_counter() - t0:.1f} s "
            f"(compile included); bpm={res[name]['bpm'].round(3).tolist()} "
            f"key={res[name]['key_idx'].tolist()}")
    bad = compare_decisions(res["gpu"], res["cpu"])
    if bad:
        raise RuntimeError("GPU vs CPU decisions differ: " + "; ".join(bad))
    log(f"[d] decisions agree on {len(tracks)} tracks within {TOLERANCES}")

    # STFT magnitudes of one full-length fullmix track vs float64 numpy
    track = x[0]
    kf, kh = _key_stft_params(cfg)
    for frame, hop, keep in (
        (kf, kh, _key_keep_bins(cfg, SR, kf)),
        (cfg.frame_size, cfg.hop_size, cfg.frame_size // 2 + 1),
    ):
        path = stft.stft_path(frame, hop, cfg.stft_bf16, keep)

        @jax.jit
        def mags(s, ln):
            outs, _, _ = stft.stft_reduce(
                s, ln, frame, hop, lambda spec, fi, fv, c: ({"m": spec}, c),
                lambda b: jnp.zeros((b,)), chunk_frames=256, keep_bins=keep,
                bf16=cfg.stft_bf16,
            )
            return outs["m"]

        got = np.asarray(mags(jax.device_put(track[None], dev),
                              jax.device_put(lens[:1], dev)))[0]
        ref = _numpy_stft_mag(track, frame, hop, keep, periodic=path == "polyphase")
        got = got[: len(ref)]
        e_ref, e_got = (ref**2).sum(-1), (got.astype(np.float64) ** 2).sum(-1)
        # the energy contract of test_stft.py: frames louder than -40 dB
        loud = e_ref >= 1e-4 * e_ref.max()
        rel = np.abs(e_got - e_ref)[loud] / e_ref[loud]
        peak_err = np.abs(got - ref).max() / ref.max()
        log(f"[d] STFT {frame}/{hop} keep={keep}: GPU path={path}, CPU path={path}, "
            f"reference=float64 numpy rfft ({'periodic' if path == 'polyphase' else 'symmetric'} Hann); "
            f"max per-frame energy error {rel.max():.2e} over {loud.mean():.1%} of frames, "
            f"max |err|/peak {peak_err:.2e}")
        if rel.max() > 1e-2 or peak_err > 2e-2:
            raise RuntimeError(f"STFT {frame}/{hop} exceeds the bf16 contract")


# A sharded program whose collectives hang never returns; the four-card
# phase bounds each run (the first includes communicator set-up) and names
# the program that did not finish.
RUN_LIMIT_S = 120.0


def _exit_hung(name: str) -> None:
    log(f"[e] {name} did not finish within {RUN_LIMIT_S:g} s")
    os._exit(1)


def run_bounded(name: str, compiled, args) -> dict:
    """Run a compiled program and read its decisions, or end the process if
    that takes longer than ``RUN_LIMIT_S``."""
    timer = threading.Timer(RUN_LIMIT_S, _exit_hung, (name,))
    timer.daemon = True
    timer.start()
    t0 = time.perf_counter()
    try:
        res = decisions(compiled(*args))
    finally:
        timer.cancel()
    log(f"[e] {name}: ran in {time.perf_counter() - t0:.2f} s")
    return res


def phase_four_cards(devs) -> None:
    import jax

    import bench
    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps, analyze_batch_arrays
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.parallel.mesh import compile_sharded, make_mesh, pad_batch_for_mesh
    from stratum_dsp_tpu.testing import kick_pattern, kick_pattern_device

    cfg, caps = AnalysisConfig(), PipelineCaps()
    fn = jax.jit(analyze_batch_arrays, static_argnames=("cfg", "sample_rate", "caps"))
    _, adv = bench.bench_mixes(BATCH)
    x = np.asarray(jax.jit(lambda v: kick_pattern_device(v, SECONDS))(adv.astype(np.float32)))
    lens = np.full((BATCH,), x.shape[1], np.int32)
    long_s = 2 * SECONDS
    seeds = [96.0, 120.0, 141.0, 163.0]
    x2 = np.stack([kick_pattern(b, long_s) for b in seeds]).astype(np.float32)
    lens2 = np.full((len(seeds),), x2.shape[1], np.int32)
    mesh, mesh2 = make_mesh(devs[:4]), make_mesh(devs[:4], n_time=2)
    x2p = pad_batch_for_mesh(x2, mesh2)

    def one_card(s, ln):
        args = (jax.device_put(s, devs[0]), jax.device_put(ln, devs[0]))
        return fn.lower(*args, cfg=cfg, sample_rate=SR, caps=caps).compile(), args

    builds = {
        "one card, B=40": lambda: one_card(x, lens),
        "1-D tracks mesh": lambda: compile_sharded(x, lens, cfg, SR, caps, mesh),
        "one card, 4 long": lambda: one_card(x2p, lens2),
        "2-D (tracks=2, time=2) mesh": lambda: compile_sharded(x2p, lens2, cfg, SR, caps, mesh2),
    }
    # XLA compiles without holding the GIL, so the four programs compile side
    # by side: the phase takes about one full-pipeline compile, not four.
    # They then run one at a time, each sharded program right after its
    # one-card reference, and each pair is compared before the next runs.
    def timed(name, build):
        t = time.perf_counter()
        program = build()
        log(f"[e] compiled {name} in {time.perf_counter() - t:.1f} s")
        return program

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, name, build) for name, build in builds.items()}
        programs = {name: f.result() for name, f in futures.items()}
    log(f"[e] 4 programs compiled side by side in {time.perf_counter() - t0:.1f} s "
        f"(B={BATCH} x {SECONDS:g} s on the 1-D mesh, 4 x {long_s:g} s on the 2-D mesh)")
    for sharded, one in (("1-D tracks mesh", "one card, B=40"),
                         ("2-D (tracks=2, time=2) mesh", "one card, 4 long")):
        res = {name: run_bounded(name, *programs[name]) for name in (one, sharded)}
        bad = compare_decisions(res[sharded], res[one])
        if bad:
            raise RuntimeError(f"{sharded} vs one card: " + "; ".join(bad))
        log(f"[e] {sharded} agrees with one card on {len(res[one]['bpm'])} tracks")
    log("[e] sharded paths agree with one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded path and its comparison")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1
    from stratum_dsp_tpu import compile_cache

    add_compile_flags(FOUR_CARD_COMPILE_FLAGS if args.four_cards else COMPILE_FLAGS)
    compile_cache.enable()  # starts the backend
    dev, smi = phase_device(n_cards)
    import jax

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(jax.devices())
    else:
        data_dir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            phase_served(data_dir)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        phase_parity(dev, phase_batch(dev, smi))
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
