"""Multi-process jax.distributed validation inside the suite (SURVEY §2.3
item 4): the 2-process x 4-virtual-CPU-device smoke run, subprocess-spawned
so the suite's own JAX backend is untouched, plus a slow-marked
production-length (180 s) 2-D mesh dryrun.

The reference has no distributed runtime to test; these cover the
framework's multi-host additions (scripts/multihost_smoke.py runbook).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_two_process_smoke():
    """Two OS processes, one 8-device tracks mesh, full SPMD pipeline."""
    env = dict(
        os.environ,
        MULTIHOST_PORT=str(_free_port()),
        JAX_PLATFORMS="cpu",
    )
    # the smoke script forces its own XLA_FLAGS; drop any suite-level forcing
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "multihost_smoke.py")],
        env=env, capture_output=True, text=True, timeout=840, cwd=REPO,
    )
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 and "UNIMPLEMENTED" in out:
        pytest.skip("jax.distributed unsupported on this backend")
    assert proc.returncode == 0, out[-4000:]
    assert "multihost smoke: OK" in out


@pytest.mark.skipif(
    os.environ.get("STRATUM_RUN_SLOW", "") != "1",
    reason="production-length CPU dryrun takes several minutes; "
           "set STRATUM_RUN_SLOW=1 (run at least once per release)",
)
def test_dryrun_2d_production_length():
    """The 2-D (tracks, time) mesh at the PRODUCTION 180 s track length on
    the virtual CPU mesh (the 3-minute shape must be exercised without an
    accelerator, not only the 24 s variant)."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        DRYRUN_SECONDS="180",
    )
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        env=env, capture_output=True, text=True, timeout=3500, cwd=REPO,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "180s tracks" in out
