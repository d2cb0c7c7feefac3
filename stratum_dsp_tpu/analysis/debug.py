"""Host-side debug-diagnostics channel.

Mirror of the reference's targeted ``eprintln!`` candidate dumps gated by
``config.debug_track_id`` / ``debug_gt_bpm`` / ``debug_top_n``
(``src/lib.rs:461-487``, ``multi_resolution.rs:276-405``), which the
validation harness captures from stderr for octave-error triage.

The jitted pipeline cannot print from inside jit, so the batched pipeline emits
the ambiguity-gate signal arrays (``dbg_*``) plus the candidate table when
``cfg.debug_track_id`` is set, and this module formats them per track on the
host after the batch returns.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np

FAMILY_FACTORS = (0.5, 2.0, 2.0 / 3.0, 1.5, 4.0 / 3.0, 0.75)


def format_debug_dump(
    host: Dict[str, np.ndarray],
    batch_index: int,
    track_id,
    gt_bpm: Optional[float] = None,
    top_n: int = 5,
) -> str:
    """Format the reference-style debug dump for one track of a batch.

    ``host`` is the pipeline output dict converted to numpy (must contain the
    ``dbg_*`` arrays, i.e. the batch ran with ``cfg.debug_track_id`` set).
    """
    i = batch_index
    lines = [f"\n=== DEBUG base tempogram (track_id={track_id}) ==="]
    if gt_bpm is not None:
        lines.append(f"GT bpm: {gt_bpm:.3f}")
    lines.append(
        "base_est: bpm={:.2f} conf={:.4f} agree={} (trap_low={} trap_high={} ambiguous={})".format(
            float(host["dbg_base_bpm"][i]),
            float(host["dbg_base_conf"][i]),
            int(host["dbg_base_agree"][i]),
            bool(host["dbg_trap_low"][i]),
            bool(host["dbg_trap_high"][i]),
            bool(host["dbg_ambiguous"][i]),
        )
    )
    lines.append(
        "ambiguity signals: family_competes={} (s_base={:.4f} s_2x={:.4f} s_half={:.4f}) "
        "weak_base={} fold_into_trap={}".format(
            bool(host["dbg_family_competes"][i]),
            float(host["dbg_s_base"][i]),
            float(host["dbg_s_2x"][i]),
            float(host["dbg_s_half"][i]),
            bool(host["dbg_weak_base"][i]),
            bool(host["dbg_fold_into_trap"][i]),
        )
    )
    if not bool(host["dbg_ambiguous"][i]):
        lines.append("NOTE: multi-res not run (outside trap zones).")

    if "cand_bpm" in host:
        lines.append(f"\n=== DEBUG candidates (track_id={track_id}) ===")
        n = 0
        order = np.argsort(-host["cand_score"][i], kind="stable")
        for j in order:
            if not host["cand_valid"][i, j] or n >= max(top_n, 1):
                continue
            n += 1
            sel = " <== selected" if host["cand_selected"][i, j] else ""
            lines.append(
                "  bpm={:7.2f} score={:.4f} fft={:.4f} ac={:.4f}{}".format(
                    float(host["cand_bpm"][i, j]),
                    float(host["cand_score"][i, j]),
                    float(host["cand_fft"][i, j]),
                    float(host["cand_ac"][i, j]),
                    sel,
                )
            )
        if gt_bpm is not None and gt_bpm > 0:
            bpms = host["cand_bpm"][i][host["cand_valid"][i]]
            in_list = bool(np.any(np.abs(bpms - gt_bpm) <= 2.0))
            fam = bool(
                np.any(
                    [np.any(np.abs(bpms - gt_bpm * f) <= 2.0) for f in FAMILY_FACTORS]
                )
            )
            lines.append(
                f"GT support: gt_in_candidates={in_list} gt_family_in_candidates={fam}"
            )
        lines.append(
            "escalation: multi_res_triggered={} multi_res_used={} "
            "percussive_triggered={} percussive_used={}".format(
                bool(host["multi_res_triggered"][i]),
                bool(host["multi_res_used"][i]),
                bool(host["percussive_triggered"][i]),
                bool(host["percussive_used"][i]),
            )
        )
    return "\n".join(lines)


def emit_debug_dump(out, cfg, batch_index: int, file=None, gt_bpm=None) -> None:
    """Print the debug dump for ``cfg.debug_track_id`` to stderr (or ``file``).

    No-op when the config has no debug track. ``out`` may be device arrays.
    """
    if cfg.debug_track_id is None:
        return
    host = {
        k: np.asarray(v)
        for k, v in out.items()
        if k.startswith(("dbg_", "cand_", "multi_res", "percussive"))
    }
    if "dbg_base_bpm" not in host:
        return
    text = format_debug_dump(
        host,
        batch_index,
        cfg.debug_track_id,
        gt_bpm=gt_bpm if gt_bpm is not None else cfg.debug_gt_bpm,
        top_n=cfg.debug_top_n,
    )
    print(text, file=file if file is not None else sys.stderr)
