"""The port's host C++, built with g++ at first use and bound with
ctypes: ``ffloader.cc`` (the ``.ffbin`` reader, ``get_lib``) and
``ffemb.cc`` (the threaded bag gather and scatter of host-resident
tables, ``get_emb_lib``), each into its own library:

    g++ -O2 -std=c++17 -shared -fPIC -pthread
        -o build/native/lib<name>-<hash>.so native/<name>.cc

into ``build/native/`` at the root of the checkout. The name carries a
hash of the source and the flags, so an edited source never loads a
stale library. The compiler writes a per-process temp file that is then
renamed into place, so parallel processes never load a half-written
library. Nothing here runs at import. A missing compiler, or a failed
build, raises: there is no pure-Python fallback reader, and the host
tables never drop to numpy for want of the library.

The JAX package's ``ffsim.cc`` (the strategy simulator, ROADMAP queue 1
item 8) is not ported yet.
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
EMB_SRC = SRC.with_name("ffemb.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_emb_lib = None


def library_path(src: Path = SRC) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def _build(out: Path, src: Path = SRC) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: native/{src.name} "
                           f"cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load(src: Path) -> ctypes.CDLL:
    out = library_path(src)
    if not out.exists():
        _build(out, src)
    return ctypes.CDLL(str(out))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.ffloader_open.restype = c.c_void_p
    lib.ffloader_open.argtypes = [c.c_char_p, c.c_int64, c.c_int32,
                                  c.c_uint64, c.c_int64, c.c_int64]
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
            _lib = _bind(_load(SRC))
    return _lib


def _bind_emb(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.ffemb_bag_gather.restype = None
    lib.ffemb_bag_gather.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int64,
        c.POINTER(c.c_int64), c.c_int64, c.c_int64, c.c_int32,
        c.POINTER(c.c_float)]
    lib.ffemb_bag_scatter.restype = None
    lib.ffemb_bag_scatter.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int64,
        c.POINTER(c.c_int64), c.c_int64, c.c_int64, c.c_int32,
        c.POINTER(c.c_float), c.c_float]
    return lib


def get_emb_lib() -> ctypes.CDLL:
    """The bound host-table gather/scatter library (``ffemb.cc``), built
    first if it is missing; raises when it cannot be built or loaded."""
    global _emb_lib
    if _emb_lib is not None:
        return _emb_lib
    with _lock:
        if _emb_lib is None:
            _emb_lib = _bind_emb(_load(EMB_SRC))
    return _emb_lib
