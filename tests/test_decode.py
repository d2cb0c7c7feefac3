"""Native decode layer: FLAC round-trips, WAV twins, error paths.

The FLAC fixtures are written by the in-repo encoder
(``testing/flac_writer.py`` — no FLAC tooling exists on this system) and must
decode BIT-IDENTICALLY to their WAV twins through the native decoder
(VERDICT r1 item 6; reference decode via symphonia,
examples/analyze_file.rs:25-180).
"""

import os
import wave

import numpy as np
import pytest

from stratum_dsp_tpu.io.decode import decode_batch, decode_file, native_lib
from stratum_dsp_tpu.testing import SAMPLE_RATE, kick_pattern
from stratum_dsp_tpu.testing.flac_writer import write_flac


def _write_wav(path, x16, sr, channels=1):
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.ascontiguousarray(x16).tobytes())


@pytest.fixture(scope="module")
def signal16():
    x = kick_pattern(124.0, 3.0)
    x16 = (np.clip(x, -1, 1) * 32000).astype(np.int16)
    x16[:4096] = 123  # constant block for the CONSTANT subframe path
    return x16


@pytest.fixture(scope="module")
def twins(tmp_path_factory, signal16):
    d = tmp_path_factory.mktemp("decode")
    wav = str(d / "sig.wav")
    flac = str(d / "sig.flac")
    _write_wav(wav, signal16, SAMPLE_RATE)
    write_flac(flac, signal16, SAMPLE_RATE, block_size=4096)
    return wav, flac


def test_flac_wav_twins_bit_identical(twins):
    wav, flac = twins
    sw, srw = decode_file(wav)
    sf, srf = decode_file(flac)
    assert srw == srf == SAMPLE_RATE
    assert len(sw) == len(sf)
    np.testing.assert_array_equal(sw, sf)


@pytest.mark.parametrize("mode", ["independent", "mid_side"])
def test_flac_stereo_modes(tmp_path, signal16, mode):
    st = np.stack([signal16, np.roll(signal16, 50)], axis=1).astype(np.int16)
    path = str(tmp_path / f"st_{mode}.flac")
    write_flac(path, st, SAMPLE_RATE, stereo_mode=mode)
    s, sr = decode_file(path)
    ref = st.astype(np.float32).mean(axis=1) / 32768.0
    assert sr == SAMPLE_RATE
    np.testing.assert_allclose(s, ref, atol=0)


def test_flac_subframe_kinds(tmp_path, signal16):
    # every frame the same kind, each kind end-to-end
    for kind in ("constant", "verbatim", "fixed0", "fixed1", "fixed2"):
        path = str(tmp_path / f"k_{kind}.flac")
        write_flac(path, signal16, SAMPLE_RATE, subframe_cycle=(kind,))
        s, _ = decode_file(path)
        np.testing.assert_array_equal(
            s, signal16.astype(np.float32) / 32768.0, err_msg=kind
        )


def test_flac_odd_tail_blocksize(tmp_path, signal16):
    x = signal16[: 4096 * 2 + 1234]  # last frame is short
    path = str(tmp_path / "tail.flac")
    write_flac(path, x, SAMPLE_RATE)
    s, _ = decode_file(path)
    assert len(s) == len(x)
    np.testing.assert_array_equal(s, x.astype(np.float32) / 32768.0)


def test_decode_batch_mixed_formats(tmp_path, signal16):
    wav = str(tmp_path / "a.wav")
    flac = str(tmp_path / "b.flac")
    bad = str(tmp_path / "c.flac")
    _write_wav(wav, signal16, SAMPLE_RATE)
    write_flac(flac, signal16, SAMPLE_RATE)
    with open(bad, "wb") as f:
        f.write(b"not a flac at all")
    out = decode_batch([wav, flac, bad])
    assert out[0][2] is None and out[1][2] is None
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[2][0] is None and out[2][2] is not None


def test_corrupt_flac_rejected(tmp_path, signal16):
    path = str(tmp_path / "trunc.flac")
    write_flac(path, signal16, SAMPLE_RATE)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 3])  # truncate mid-frame
    # truncated stream: partial decode (prefix frames) or clean error; the
    # native layer must not crash or return garbage lengths
    try:
        s, sr = decode_file(path)
        assert len(s) <= len(signal16)
        if len(s):
            np.testing.assert_array_equal(
                s, signal16[: len(s)].astype(np.float32) / 32768.0
            )
    except IOError:
        pass


def test_native_lib_builds():
    lib = native_lib()
    assert lib is not None, "native decoder must build in this environment"
    assert lib.sa_mp3_available() in (0, 1)
    assert lib.sa_ogg_available() in (0, 1)
    assert lib.sa_ffmpeg_available() in (0, 1)


def test_native_lib_builds_without_ffmpeg_headers(tmp_path, signal16):
    """On a host without the libav* headers the library still builds: the
    ffmpeg formats report unavailable, WAV decodes as before."""
    import ctypes
    import subprocess

    from stratum_dsp_tpu.io import decode

    src = decode._NATIVE_DIR
    so = tmp_path / "libstub.so"
    subprocess.run(
        ["g++", "-O1", "-shared", "-fPIC", "-std=c++17", "-DSTRATUM_NO_FFMPEG",
         "-o", str(so), str(src / "stratum_audio.cpp"), str(src / "flac_decoder.cpp"),
         str(src / "ffmpeg_decoder.cpp"), "-ldl", "-lpthread"],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(so))
    lib.sa_ffmpeg_available.restype = ctypes.c_int
    assert lib.sa_ffmpeg_available() == 0
    wav = str(tmp_path / "x.wav")
    _write_wav(wav, signal16, SAMPLE_RATE)
    out = ctypes.POINTER(ctypes.c_float)()
    n, sr = ctypes.c_int64(), ctypes.c_int()
    lib.sa_decode_file.restype = ctypes.c_int
    lib.sa_decode_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
    ]
    assert lib.sa_decode_file(wav.encode(), 0, 0, ctypes.byref(out), ctypes.byref(n),
                              ctypes.byref(sr)) == 0
    assert n.value == len(signal16) and sr.value == SAMPLE_RATE


def test_mp3_ogg_roundtrip(tmp_path, signal16):
    """Real MP3/OGG files through the libmpg123/libvorbisfile decode paths.

    Regression for the MPG123_NEW_FORMAT bug: the first mpg123_read after
    open reports a format refresh (not audio), which the old loop treated
    as an error — every real-world MP3 decoded to zero samples
    ("unrecognized format") while the unit suite only checked availability.
    """
    from stratum_dsp_tpu.io.decode import encode_audio, ffmpeg_available

    if not ffmpeg_available():
        pytest.skip("libavformat/libavcodec not present")
    x = signal16.astype(np.float32) / 32768.0
    for ext, codec in (("mp3", "libmp3lame"), ("ogg", "libvorbis")):
        path = str(tmp_path / f"sig.{ext}")
        try:
            encode_audio(path, x, SAMPLE_RATE, codec)
        except IOError:
            pytest.skip(f"{codec} encoder not present")
        y, sr = decode_file(path)
        assert sr == SAMPLE_RATE, ext
        assert abs(len(y) - len(x)) < 4096, (ext, len(y), len(x))
        n = min(len(x), len(y))
        corr = float(
            np.dot(x[:n], y[:n])
            / (np.linalg.norm(x[:n]) * np.linalg.norm(y[:n]) + 1e-12)
        )
        assert corr > 0.95, (ext, corr)


def test_m4a_roundtrip(tmp_path, signal16):
    """m4a/AAC decode via the dlopen'd ffmpeg path (symphonia's m4a coverage,
    analyze_file.rs:25-180). AAC is lossy: assert alignment + high correlation
    rather than bit equality."""
    from stratum_dsp_tpu.io.decode import encode_m4a, ffmpeg_available

    if not ffmpeg_available():
        pytest.skip("libavformat/libavcodec not present")
    x = signal16.astype(np.float32) / 32768.0
    path = str(tmp_path / "sig.m4a")
    encode_m4a(path, x, SAMPLE_RATE)
    y, sr = decode_file(path)
    assert sr == SAMPLE_RATE
    # encoder may pad the tail to a frame boundary
    assert len(x) <= len(y) <= len(x) + 4096
    n = min(len(x), len(y))
    seg_x, seg_y = x[:n], y[:n]
    corr = float(
        np.dot(seg_x, seg_y)
        / (np.linalg.norm(seg_x) * np.linalg.norm(seg_y) + 1e-12)
    )
    # the mp4 edit list must absorb the AAC priming delay (zero lag)
    assert corr > 0.97, corr


def test_m4a_in_decode_batch(tmp_path, signal16):
    from stratum_dsp_tpu.io.decode import encode_m4a, ffmpeg_available

    if not ffmpeg_available():
        pytest.skip("libavformat/libavcodec not present")
    x = signal16.astype(np.float32) / 32768.0
    wav = str(tmp_path / "a.wav")
    m4a = str(tmp_path / "b.m4a")
    _write_wav(wav, signal16, SAMPLE_RATE)
    encode_m4a(m4a, x, SAMPLE_RATE)
    out = decode_batch([wav, m4a])
    assert out[0][2] is None and out[1][2] is None
    assert out[0][1] == out[1][1] == SAMPLE_RATE
