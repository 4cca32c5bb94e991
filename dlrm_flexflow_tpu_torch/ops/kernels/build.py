"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/lib<name>-<hash>.so

into ``build/kernels/`` at the root of the checkout, at first use. The
file name carries a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source never loads a stale library. ``build_all`` starts one nvcc per source at
once and waits for all of them; ``load`` builds one library if it is
missing and loads it. Nothing here runs at import: the CPU tests import
every module, and a machine without a GPU may have no nvcc. A missing nvcc, or a
failed build, raises — a CUDA tensor never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("dense_update", "embedding_bag", "interaction", "lstm",
           "quant_rows", "scatter_rows", "topk")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc, from PyTorch's CUDA_HOME or the PATH; raises when
    there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (no CUDA_HOME/bin/nvcc and none on PATH): the "
        "port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str, compiler: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns {name: compiler output} for
    the sources it compiled (register and shared-memory use, from
    -Xptxas=-v); raises if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    started = [(n, *_start(n, compiler)) for n in todo]
    logs, failed = {}, []
    for name, proc, tmp, out in started:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a reader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing.
    ``signatures`` maps each C function to (argtypes, restype) and is
    applied at the first load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            lib.ff_error_string.argtypes = [ctypes.c_int]
            lib.ff_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err:
        msg = lib.ff_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def count_launch(wrapper, route: str = None) -> None:
    """Add one to ``wrapper.launches`` and, for a wrapper with several
    routes, to ``wrapper.routes[route]``. Wrappers launch from several
    threads at once (serving clients, the shard pool), so the count is
    taken under a lock."""
    with _count_lock:
        wrapper.launches += 1
        if route is not None:
            wrapper.routes[route] += 1


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
