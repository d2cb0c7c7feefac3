#!/usr/bin/env python
"""Two-process ``jax.distributed`` smoke test on CPU (multi-host runbook).

The multi-host path is validated without a cluster: two OS processes, each owning 4
virtual CPU devices, joined by ``jax.distributed.initialize`` into one
8-device ``tracks`` mesh. Per-process shards are assembled with
``jax.make_array_from_process_local_data`` and the FULL analysis pipeline
runs as one SPMD program across both processes; process 0 checks the BPM
outputs of ITS addressable shards against expectations.

On real GPU hosts the only changes are: drop the env forcing (each process
sees its local GPUs), and initialize() with the cluster's coordinator
address — the mesh/sharding/pipeline code is identical (SURVEY §2.3 item 4).

Run: python scripts/multihost_smoke.py            # parent, spawns 2 workers
     (workers are re-invocations with MULTIHOST_RANK set)
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COORD = f"localhost:{os.environ.get('MULTIHOST_PORT', '29671')}"
N_PROC = 2
LOCAL_DEVICES = 4


def worker(rank: int) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=COORD, num_processes=N_PROC, process_id=rank
    )
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stratum_dsp_tpu.analysis.pipeline import PipelineCaps, analyze_batch_arrays
    from stratum_dsp_tpu.config import AnalysisConfig
    from stratum_dsp_tpu.parallel.mesh import make_mesh
    from stratum_dsp_tpu.testing import kick_pattern

    assert jax.process_count() == N_PROC
    assert len(jax.devices()) == N_PROC * LOCAL_DEVICES, len(jax.devices())

    mesh = make_mesh()  # global 8-device tracks mesh
    sharding = NamedSharding(mesh, P("tracks"))

    sr = 44100
    secs = 4.0
    b_global = N_PROC * LOCAL_DEVICES
    bpms = np.linspace(90.0, 160.0, b_global)
    t = int(secs * sr)

    # each process synthesizes only ITS tracks (process-local data)
    lo = rank * LOCAL_DEVICES
    local = np.stack(
        [kick_pattern(x, secs) for x in bpms[lo : lo + LOCAL_DEVICES]]
    ).astype(np.float32)
    samples = jax.make_array_from_process_local_data(
        sharding, local, (b_global, t)
    )
    lengths = jax.make_array_from_process_local_data(
        sharding, np.full((LOCAL_DEVICES,), t, np.int32), (b_global,)
    )

    cfg = AnalysisConfig()
    caps = PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=16, max_segments=6)
    fn = jax.jit(
        analyze_batch_arrays,
        static_argnums=(2, 3, 4),
        in_shardings=(sharding, sharding),
        out_shardings=sharding,
    )
    out = fn(samples, lengths, cfg, sr, caps)
    jax.block_until_ready(out)

    # check this process's addressable shards
    ok = True
    for shard in out["bpm"].addressable_shards:
        i = shard.index[0].start
        got = float(np.asarray(shard.data)[0])
        want = bpms[i]
        fam = min(abs(got - want), abs(got - 2 * want), abs(got - 0.5 * want))
        print(f"[rank {rank}] track {i}: bpm={got:.2f} (want {want:.1f}) "
              f"{'OK' if fam < 2.0 else 'MISS'}", flush=True)
        ok &= fam < 2.0
    jax.distributed.shutdown()
    return 0 if ok else 1


def main() -> int:
    rank = os.environ.get("MULTIHOST_RANK")
    if rank is not None:
        return worker(int(rank))
    procs = []
    for r in range(N_PROC):
        env = dict(os.environ, MULTIHOST_RANK=str(r))
        procs.append(
            subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env)
        )
    rc = 0
    for p in procs:
        rc |= p.wait()
    print("multihost smoke:", "OK" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
