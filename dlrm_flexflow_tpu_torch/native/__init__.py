"""The port's host C++ (``ffloader.cc``), built with g++ at first use and
bound with ctypes.

    g++ -O2 -std=c++17 -shared -fPIC -pthread
        -o build/native/libffloader-<hash>.so native/ffloader.cc

into ``build/native/`` at the root of the checkout. The name carries a
hash of the source and the flags, so an edited source never loads a
stale library. The compiler writes a per-process temp file that is then
renamed into place, so parallel processes never load a half-written
library. Nothing here runs at import. A missing compiler, or a failed
build, raises: there is no pure-Python fallback reader.

The JAX package's ``ffemb.cc`` (host-resident tables, ROADMAP queue 1
item 2.4) and ``ffsim.cc`` (the strategy simulator, item 8) are not
ported yet.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "ffloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libffloader-{digest[:16]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native .ffbin "
                           "loader (native/ffloader.cc) cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.ffloader_open.restype = c.c_void_p
    lib.ffloader_open.argtypes = [c.c_char_p, c.c_int64, c.c_int32,
                                  c.c_uint64]
    lib.ffloader_meta.restype = None
    lib.ffloader_meta.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
    lib.ffloader_next.restype = c.c_int64
    lib.ffloader_next.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                  c.POINTER(c.c_int32), c.POINTER(c.c_float)]
    lib.ffloader_close.restype = None
    lib.ffloader_close.argtypes = [c.c_void_p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The bound loader library, built first if it is missing; raises
    when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            _lib = _bind(ctypes.CDLL(str(out)))
    return _lib
