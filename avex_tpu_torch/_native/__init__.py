"""Native (C++) audio decode and resample on the host, with a numpy/scipy fallback.

Counterpart of ``avex_tpu/_native/__init__.py``, with its own copy of
``audio_native.cpp`` (RIFF/WAV and FLAC parsing, channel mixdown,
windowed-sinc resampling) behind a C ABI loaded with ``ctypes``. The library
is compiled by ``g++`` at first use into ``build/`` at the root of the
checkout, named by a hash of the source. Without a compiler, WAV decoding and
resampling fall back to scipy, as in the JAX package; FLAC needs the library.
This is host I/O, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import logging
import os
import subprocess
import tempfile
import threading
from math import gcd
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from avex_tpu_torch.ops._build import BUILD_DIR

__all__ = [
    "decode_audio",
    "decode_audio_bytes",
    "decode_flac",
    "decode_wav",
    "native_available",
    "pcm_to_float",
    "resample",
]

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parent / "audio_native.cpp"
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_F32 = ctypes.POINTER(ctypes.c_float)


def _build_library() -> Optional[Path]:
    """Compile the library into ``build/`` unless one of the same hash exists."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    target = BUILD_DIR / f"libavexaudio-{digest}.so"
    if target.exists():
        return target
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SOURCE), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return target
    except (subprocess.SubprocessError, OSError) as err:
        logger.info("native audio build unavailable (%s); using the numpy/scipy fallback", err)
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _LOCK:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build_library()
        if path is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        lib.avex_decode_wav.restype = ctypes.c_int
        lib.avex_decode_wav.argtypes = [ctypes.c_char_p, ctypes.c_int64, _F32, ctypes.c_int64, i32p, i32p, i64p]
        lib.avex_decode_flac.restype = ctypes.c_int
        lib.avex_decode_flac.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _F32, ctypes.c_int64, i32p, i32p, i64p, i32p,
        ]
        lib.avex_mix_to_mono.argtypes = [_F32, ctypes.c_int64, ctypes.c_int32, _F32]
        lib.avex_resample.argtypes = [
            _F32, ctypes.c_int64, ctypes.c_int32, _F32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the compiled library is (or can be made) available."""
    return _get_lib() is not None


def pcm_to_float(wav: np.ndarray) -> np.ndarray:
    """Integer PCM → float32 in [-1, 1], scaled by the original dtype."""
    if wav.dtype == np.int16:
        return wav.astype(np.float32) / 2.0**15
    if wav.dtype == np.int32:
        return wav.astype(np.float32) / 2.0**31
    if wav.dtype == np.uint8:
        return (wav.astype(np.float32) - 128.0) / 128.0
    return wav.astype(np.float32)


def _decode_native(lib: ctypes.CDLL, data: bytes, flac: bool) -> Tuple[int, np.ndarray, int, int, int]:
    """Two-pass decode (metadata, then samples) through the C ABI.

    Returns ``(rc, interleaved samples, sample rate, channels, md5 status)``;
    rc 0 means success.
    """
    sr, channels, frames, md5 = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32()

    def call(buf: Optional[np.ndarray]) -> int:
        out = buf.ctypes.data_as(_F32) if buf is not None else None
        size = buf.size if buf is not None else 0
        meta = (ctypes.byref(sr), ctypes.byref(channels), ctypes.byref(frames))
        if flac:
            return lib.avex_decode_flac(data, len(data), out, size, *meta, ctypes.byref(md5))
        return lib.avex_decode_wav(data, len(data), out, size, *meta)

    buf = np.empty(0, np.float32)
    rc = call(None)
    if rc == 0:
        buf = np.empty(frames.value * channels.value, np.float32)
        rc = call(buf)
    return rc, buf[: frames.value * channels.value], sr.value, channels.value, md5.value


def _layout(lib: ctypes.CDLL, buf: np.ndarray, channels: int, mono: bool) -> np.ndarray:
    """Interleaved samples → mono (mixed down natively) or ``[frames, channels]``."""
    frames = buf.size // channels
    if mono and channels > 1:
        out = np.empty(frames, np.float32)
        lib.avex_mix_to_mono(buf.ctypes.data_as(_F32), frames, channels, out.ctypes.data_as(_F32))
        return out
    return buf.reshape(frames, channels).squeeze()


def _decode_wav_bytes(data: bytes, mono: bool) -> Tuple[np.ndarray, int]:
    lib = _get_lib()
    if lib is not None:
        rc, buf, sr, channels, _ = _decode_native(lib, data, flac=False)
        if rc == 0:
            return _layout(lib, buf, channels, mono), sr
        logger.debug("native wav decode failed (rc=%d); scipy fallback", rc)
    from scipy.io import wavfile

    sr, wav = wavfile.read(io.BytesIO(data))
    wav = pcm_to_float(wav)
    if mono and wav.ndim == 2:
        wav = wav.mean(axis=1)
    return wav, int(sr)


def _decode_flac_bytes(data: bytes, mono: bool, verify_md5: bool) -> Tuple[np.ndarray, int]:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("FLAC decode requires the native audio library (g++ unavailable?)")
    rc, buf, sr, channels, md5 = _decode_native(lib, data, flac=True)
    if rc != 0:
        raise ValueError(f"FLAC decode failed (rc={rc})")
    if verify_md5 and md5 == -1:
        raise ValueError("FLAC MD5 signature mismatch (corrupt decode)")
    return _layout(lib, buf, channels, mono), sr


def decode_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a WAV file → (float32 waveform in [-1, 1], sample_rate).

    Native parser when available, scipy otherwise; ``mono=True`` averages
    channels.
    """
    return _decode_wav_bytes(Path(path).read_bytes(), mono)


def decode_flac(path: str, mono: bool = True, verify_md5: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file → (float32 waveform in [-1, 1], sample_rate).

    Native only. The decode is checked against the MD5 of the unencoded audio
    in the file's STREAMINFO block (``verify_md5=False`` skips the check).
    """
    return _decode_flac_bytes(Path(path).read_bytes(), mono, verify_md5)


def decode_audio(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a WAV or FLAC file, told apart by its first four bytes."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        return decode_flac(path, mono=mono)
    return decode_wav(path, mono=mono)


def decode_audio_bytes(data: bytes, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode in-memory WAV or FLAC bytes (e.g. an HTTP request body)."""
    if data[:4] == b"fLaC":
        return _decode_flac_bytes(data, mono, verify_md5=True)
    return _decode_wav_bytes(data, mono)


def resample(wav: np.ndarray, sr_in: int, sr_out: int, taps: int = 16) -> np.ndarray:
    """Resample mono float32 audio (windowed sinc natively, scipy's polyphase otherwise)."""
    wav = np.ascontiguousarray(wav, np.float32)
    if sr_in == sr_out:
        return wav
    n_out = int(len(wav) * sr_out / sr_in)
    lib = _get_lib()
    if lib is not None:
        out = np.empty(n_out, np.float32)
        lib.avex_resample(wav.ctypes.data_as(_F32), len(wav), sr_in, out.ctypes.data_as(_F32), n_out, sr_out, taps)
        return out
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(wav, sr_out // g, sr_in // g).astype(np.float32)[:n_out]
