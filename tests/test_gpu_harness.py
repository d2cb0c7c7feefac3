"""The GPU harness on a host without a GPU: compile-cache placement,
``chip_smoke.py``'s refusal and decision rules, ``bench.py``'s peak table,
gates and FLOP model."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from stratum_dsp_tpu import compile_cache  # noqa: E402


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir("gpu") == str(tmp_path)
    cpu = compile_cache.cache_dir("cpu")
    assert os.path.dirname(cpu) == str(tmp_path)
    assert os.path.basename(cpu) == f"cpu-{compile_cache.host_fingerprint()}"


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir("gpu") == os.path.join(REPO, ".jax_cache")
    assert os.path.dirname(compile_cache.cache_dir("cpu")) == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script, tmp_path):
    """Without a GPU both exit non-zero before compiling anything, and never
    print a result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], capture_output=True, text=True,
        timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"metric"' not in proc.stdout
    assert "GPU" in proc.stderr
    # nothing was compiled, so nothing reached the persistent cache
    cached = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert cached == []


def _grid(n, start=1.0, period=0.5):
    return start + period * np.arange(n)


def _decisions(**kw):
    d = {
        "key_idx": np.asarray([0, 12, 5]),
        "bpm": np.asarray([120.0, 95.5, 140.25]),
        "beats": [_grid(360), _grid(280), _grid(410)],
        "downbeats": [_grid(90, period=2.0), _grid(70, period=2.0), _grid(103, period=2.0)],
        "stability": np.asarray([0.99, 0.97, 0.95]),
    }
    d.update(kw)
    return d


@pytest.mark.parametrize(
    "change,n_bad",
    [
        ({}, 0),
        ({"bpm": [120.08, 95.45, 140.25]}, 0),  # within 0.1 BPM
        ({"beats": [_grid(361), _grid(279), _grid(410)],
          "downbeats": [_grid(89, period=2.0), _grid(71, period=2.0), _grid(103, period=2.0)]}, 0),
        # the grid starts 12 beats later on the same lattice: a knife edge
        ({"beats": [_grid(348, start=7.0), _grid(280), _grid(410)]}, 0),
        ({"key_idx": [0, 0, 5]}, 1),  # A minor flipped to C major
        ({"bpm": [120.0, 95.5, 140.5]}, 1),
        ({"beats": [_grid(358, start=1.25), _grid(280), _grid(410)]}, 1),  # off-phase
        # 9% of the grid lost on the same lattice: within the knife edge
        ({"beats": [_grid(328, start=17.0), _grid(280), _grid(410)]}, 0),
        ({"beats": [_grid(252, start=55.0), _grid(280), _grid(410)]}, 1),  # 30% lost
        ({"beats": [_grid(150), _grid(280), _grid(410)]}, 1),  # most of the grid lost
        ({"downbeats": [_grid(120, period=1.5), _grid(70, period=2.0),
                        _grid(103, period=2.0)]}, 1),  # 3/4 against 4/4
        ({"stability": [0.99, 0.94, 0.95]}, 1),
    ],
)
def test_parity_decision_rules(change, n_bad):
    bad = chip_smoke.compare_decisions(_decisions(**change), _decisions())
    assert len(bad) == n_bad, bad


def test_four_card_run_that_hangs_ends_the_process():
    """A sharded program whose collectives hang never returns: the bounded
    run names it and ends the process non-zero instead of waiting."""
    code = ("import time, chip_smoke as cs; cs.RUN_LIMIT_S = 0.2; "
            "cs.run_bounded('2-D mesh', lambda: time.sleep(30), ()); print('returned')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 1
    assert "2-D mesh did not finish within 0.2 s" in proc.stdout
    assert "returned" not in proc.stdout


def test_peak_table_refuses_unknown_device():
    assert bench.peaks_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(KeyError):
        bench.peaks_for("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError):
        bench.peaks_for("cpu")


def test_bench_gates_and_mixes():
    clean, adv = bench.bench_mixes(40)
    assert clean.shape == adv.shape == (40,)
    trap = (adv < 85.0) | (adv >= 170.0)
    assert trap.sum() == 12
    # trap-high seeds may fold to half; core seeds must be exact
    got = np.where(adv >= 170.0, adv / 2, adv)
    assert bench.bpm_gates(got, adv) == (float(np.mean(adv < 170.0)), 1.0, 1.0)
    got[0] = adv[0] * 1.5
    exact, core, family = bench.bpm_gates(got, adv)
    assert core < 1.0 and family < 1.0


def test_analytic_flops_follow_stft_path(monkeypatch):
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.ops import stft

    cfg, n = AnalysisConfig(), 180 * bench.SR
    taken = bench.analytic_flops(cfg, n, 40, 5)
    assert taken > 0
    assert stft.stft_path(8192, 512, True, 930) == "polyphase"
    monkeypatch.setattr(stft, "use_polyphase", lambda *a, **k: False)
    assert stft.stft_path(8192, 512, True, 930) == "rfft"
    assert bench.analytic_flops(cfg, n, 40, 5) != taken
