"""Audio decode: native C++ library (WAV; FLAC via the from-scratch decoder
in native/flac_decoder.cpp; MP3 via libmpg123; OGG via libvorbisfile; threaded
batch pool) with a pure-Python WAV fallback.

The native library (``native/stratum_audio.cpp``) replaces the reference's
symphonia decode layer (examples/analyze_file.rs:25-180) and rayon batch pool
(examples/analyze_batch.rs:239-262). It is built on demand with g++ and
loaded via ctypes; if the toolchain is unavailable, WAV decoding falls back
to the stdlib ``wave`` module.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import wave
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
# STRATUM_NATIVE_DIR overrides the source/library directory for installs
# where the package does not live inside the repo checkout.
_NATIVE_DIR = Path(os.environ.get("STRATUM_NATIVE_DIR", _REPO_ROOT / "native"))
_NATIVE_SRC = _NATIVE_DIR / "stratum_audio.cpp"
_NATIVE_LIB = _NATIVE_DIR / "libstratum_audio.so"

MIX_AVERAGE = 0
MIX_DOMINANT = 1

_ERR_NAMES = {
    1: "could not open file",
    2: "unrecognized format",
    3: "unsupported sample format",
    4: "allocation failure",
    5: "mp3 decoding unavailable (libmpg123 not found)",
    6: "ogg decoding unavailable (libvorbisfile not found)",
    7: "ffmpeg decoding unavailable (libavformat/libavcodec not found)",
}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
build_error = ""  # why the last native build failed, for diagnostics


def _build_native() -> bool:
    global build_error
    try:
        subprocess.run(
            [
                "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                "-o", str(_NATIVE_LIB), str(_NATIVE_SRC),
                str(_NATIVE_SRC.parent / "flac_decoder.cpp"),
                str(_NATIVE_SRC.parent / "ffmpeg_decoder.cpp"),
                "-ldl", "-lpthread",
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except subprocess.CalledProcessError as e:
        build_error = e.stderr.decode(errors="replace")[-2000:]
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = str(e)
    return False


def native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native decoder; None if unavailable."""
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        srcs = [
            _NATIVE_SRC,
            _NATIVE_SRC.parent / "flac_decoder.cpp",
            _NATIVE_SRC.parent / "ffmpeg_decoder.cpp",
        ]
        if not _NATIVE_LIB.exists() or any(
            s.exists() and s.stat().st_mtime > _NATIVE_LIB.stat().st_mtime
            for s in srcs
        ):
            if not _NATIVE_SRC.exists() or not _build_native():
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_NATIVE_LIB))
        except OSError:
            _lib_failed = True
            return None
        lib.sa_decode_file.restype = ctypes.c_int
        lib.sa_decode_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ]
        lib.sa_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.sa_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.sa_mp3_available.restype = ctypes.c_int
        lib.sa_ogg_available.restype = ctypes.c_int
        lib.sa_ffmpeg_available.restype = ctypes.c_int
        lib.sa_encode_m4a.restype = ctypes.c_int
        lib.sa_encode_m4a.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int,
        ]
        if hasattr(lib, "sa_encode_audio"):
            lib.sa_encode_audio.restype = ctypes.c_int
            lib.sa_encode_audio.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ]
        _lib = lib
        return _lib


def _decode_wav_python(path: str, mix_mode: int) -> Tuple[np.ndarray, int]:
    """stdlib WAV fallback (PCM 8/16/32; 24-bit handled manually)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32) << 8)
            | (b[:, 1].astype(np.int32) << 16)
            | (b[:, 2].astype(np.int32) << 24)
        ).astype(np.int32)
        x = (x >> 8).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    x = x.reshape(-1, ch)
    if ch == 1:
        mono = x[:, 0]
    elif mix_mode == MIX_DOMINANT and ch == 2:
        mono = np.where(np.abs(x[:, 0]) >= np.abs(x[:, 1]), x[:, 0], x[:, 1])
    else:
        mono = x.mean(axis=1)
    return np.ascontiguousarray(mono, np.float32), sr


def decode_file(
    path: str, target_sr: int = 0, mix_mode: int = MIX_AVERAGE
) -> Tuple[np.ndarray, int]:
    """Decode one file to mono float32. Returns (samples, sample_rate)."""
    lib = native_lib()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int64()
        sr = ctypes.c_int()
        rc = lib.sa_decode_file(
            path.encode(), target_sr, mix_mode, ctypes.byref(out),
            ctypes.byref(n), ctypes.byref(sr),
        )
        if rc == 0:
            arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
            lib.sa_free(out)
            return arr, sr.value
        if rc != 5 and not path.lower().endswith(".wav"):
            raise IOError(f"decode failed for {path}: {_ERR_NAMES.get(rc, rc)}")
    samples, sr_out = _decode_wav_python(path, mix_mode)
    if target_sr and sr_out != target_sr:
        # linear resample to target (native path does this in C++)
        ratio = sr_out / target_sr
        n_out = int(len(samples) / ratio)
        pos = np.arange(n_out) * ratio
        i0 = pos.astype(np.int64)
        i1 = np.minimum(i0 + 1, len(samples) - 1)
        frac = (pos - i0).astype(np.float32)
        samples = samples[i0] * (1 - frac) + samples[i1] * frac
        sr_out = target_sr
    return samples.astype(np.float32), sr_out


def ffmpeg_available() -> bool:
    """True if the dlopen'd libavformat/libavcodec path is usable."""
    lib = native_lib()
    return bool(lib is not None and lib.sa_ffmpeg_available())


def encode_m4a(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Encode mono f32 samples to AAC-in-m4a (test-fixture tool only; the
    analysis framework never encodes)."""
    encode_audio(path, samples, sample_rate, codec="")


def encode_audio(
    path: str, samples: np.ndarray, sample_rate: int, codec: str = ""
) -> None:
    """Encode mono f32 samples via a named avcodec encoder (fixture tool
    only). ``codec`` is the avcodec encoder name — "libmp3lame" for .mp3,
    "libvorbis" for .ogg, "" for AAC/.m4a; the container comes from the
    path suffix. Powers the lossy-codec battery families
    (validation/tools/run_battery.py --codec)."""
    lib = native_lib()
    if lib is None or not lib.sa_ffmpeg_available():
        raise IOError("ffmpeg encode unavailable")
    if not hasattr(lib, "sa_encode_audio"):
        raise IOError("native library too old: rebuild libstratum_audio.so")
    x = np.ascontiguousarray(np.asarray(samples, np.float32))
    rc = lib.sa_encode_audio(
        path.encode(), codec.encode(),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sample_rate,
    )
    if rc != 0:
        raise IOError(f"encode failed for {path}: {_ERR_NAMES.get(rc, rc)}")


def decode_batch(
    paths: Sequence[str],
    target_sr: int = 0,
    mix_mode: int = MIX_AVERAGE,
    n_threads: int = 0,
) -> List[Tuple[Optional[np.ndarray], int, Optional[str]]]:
    """Threaded batch decode. Returns [(samples|None, sr, error|None)]."""
    lib = native_lib()
    if lib is None:
        out = []
        for p in paths:
            try:
                s, sr = decode_file(p, target_sr, mix_mode)
                out.append((s, sr, None))
            except Exception as e:  # noqa: BLE001
                out.append((None, 0, str(e)))
        return out

    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_int64 * n)()
    srs = (ctypes.c_int * n)()
    errs = (ctypes.c_int * n)()
    lib.sa_decode_batch(c_paths, n, target_sr, mix_mode, n_threads, outs, lens, srs, errs)
    results = []
    for i in range(n):
        if errs[i] == 0:
            arr = np.ctypeslib.as_array(outs[i], shape=(lens[i],)).copy()
            lib.sa_free(outs[i])
            results.append((arr, srs[i], None))
        else:
            results.append((None, 0, _ERR_NAMES.get(errs[i], str(errs[i]))))
    return results
