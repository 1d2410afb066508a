"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every ``*.cu`` under ``csrc/`` is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false``) into a shared
library with a plain C interface — seconds per source, where a build that
includes PyTorch's headers takes minutes.  The libraries land in
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of source and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing is built at import time: the first launch
builds every missing library, one ``nvcc`` per source, all started
together.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero value.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(stem: str) -> Path:
    src = CSRC / f"{stem}.cu"
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{tag}.so"


def build_all() -> Dict[str, str]:
    """Compile every source under ``csrc/`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns ``{source name:
    ptxas report}`` for the sources built now (registers, shared memory,
    spills); raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = library_path(src.stem)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    reports, failed = {}, []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
        reports[src.name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(stem: str) -> ctypes.CDLL:
    """The bound library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            path = library_path(stem)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _LIBS[stem] = lib
        return lib


def check(lib: ctypes.CDLL, stem: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        describe = getattr(lib, f"{stem}_error_string")
        describe.restype = ctypes.c_char_p
        describe.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{stem}: CUDA error {err} "
                           f"({describe(err).decode()})")
