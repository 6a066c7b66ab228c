"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/kernels/<name>-<hash>.so`` at the repository root, for
``sm_90a`` (Hopper), at first use. The hash is of the source text, so an
edited kernel is rebuilt and a stale library is never loaded. Nothing is
built when a module is imported: the package imports on a machine with no
``nvcc`` and no card, and only a CUDA tensor reaching a wrapper builds.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` right after its launch; ``check`` raises on a
non-zero code, so a launch the card refused never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: list[str]) -> None:
    """Compile every named kernel that is not built yet, one nvcc each, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        jobs.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """C function ``symbol`` of ``csrc/<name>.cu``, building the library on first use.

    ``argtypes`` must give ``ctypes.c_void_p`` for every pointer and the
    stream: ctypes would otherwise pass a Python int as a 32-bit int.
    """
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_libs[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
