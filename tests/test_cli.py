"""analyze_file CLI: bucket padding never cuts a track."""

import json
import wave

import numpy as np

from stratum_dsp_tpu.cli import analyze_file
from stratum_dsp_tpu.testing import SAMPLE_RATE, kick_pattern


def test_padded_length_buckets_and_long_tracks(monkeypatch):
    sr = 1000
    monkeypatch.setattr(analyze_file, "BUCKETS", (2.0, 4.0))
    assert analyze_file.padded_length(1500, sr) == 2000
    assert analyze_file.padded_length(4000, sr) == 4000
    # longer than the largest bucket: the next multiple of it, not a cut
    assert analyze_file.padded_length(4001, sr) == 8000
    assert analyze_file.padded_length(9000, sr) == 12000


def test_track_longer_than_largest_bucket_is_analysed_to_its_end(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(analyze_file, "BUCKETS", (2.0, 4.0))
    x = kick_pattern(120.0, 10.0)
    path = str(tmp_path / "long.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    assert analyze_file.main([path, "--json"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # duration after silence trimming; a cut at the 4 s bucket would give < 4 s
    assert 9.0 < d["duration_seconds"] <= 10.0
    assert abs(d["bpm"] - 120.0) < 2.0
    # 120 BPM over 10 s: ~20 beats; a cut at the 4 s bucket would leave <= 8
    assert d["beat_count"] >= 16
