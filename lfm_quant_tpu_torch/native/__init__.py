"""The native (C++) sampler and CSV parser, bound with ``ctypes``: the
port's loader for ``panel_native.cpp`` (a copy of the JAX package's
source): ``sample_epoch`` draws one epoch of ``[K, D, Bf]`` window-index
batches (``data/windows.py DateBatchSampler(engine="native")``),
``csv_parse_buf`` parses a long-format panel file in memory
(``data/compustat.py load_compustat_csv(engine="native")``).

Build model: compiled on first use with ``g++ -O3 -shared`` (no
``-march=native``: the library may be loaded on another host) into
``build/lfm_quant_tpu_torch/`` at the checkout's root, never into the
package directory; the library's name carries a hash of the source and
the flags, so an edited source is never served by a stale build. Nothing
is built at import. :func:`get_lib` returns None when no toolchain can
build it: ``engine="native"`` then raises and ``"auto"`` takes the Python
engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "panel_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lfm_quant_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the build of this source and these flags lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"panel_native_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    """Compile the library to ``so``; False (with the compiler's message
    on stderr) when ``g++`` is missing or fails. Each process writes its
    own temporary file and renames it into place."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"lfm_quant_tpu_torch.native: build skipped ({e})",
              file=sys.stderr)
        return False
    if proc.returncode != 0:
        print(f"lfm_quant_tpu_torch.native: g++ failed:\n"
              f"{proc.stderr[:2000]}", file=sys.stderr)
        return False
    os.replace(tmp, so)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.csv_parse_buf.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_longlong,
        i32p, i32p, f32p, f32p,
    ]
    lib.csv_parse_buf.restype = ctypes.c_longlong
    lib.sample_epoch.argtypes = [
        i32p, ctypes.c_longlong, i32p, i64p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, i32p, i32p, f32p,
    ]
    lib.sample_epoch.restype = ctypes.c_longlong
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it cannot
    be built or loaded (a failure is remembered for the process)."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(so)))
        except OSError as e:
            print(f"lfm_quant_tpu_torch.native: load failed ({e})",
                  file=sys.stderr)
            _build_failed = True
            return None
    return _lib


def available() -> bool:
    """Whether the native sampler can run here (builds it if needed)."""
    return get_lib() is not None
