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
``cudaGetLastError()``; :func:`check` raises on a non-zero value.  A
wrapper binds its entry point once (:func:`bind`) and calls it through
:func:`launch`, which passes the raw handle of the current stream: the
turn loops and decode make short calls, where building a
``torch.cuda.Stream`` or entering ``torch.cuda.device`` would cost more
than the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Tuple[ctypes.CDLL, Any]] = {}
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


def bind(stem: str, entry: str, argtypes: Sequence[Any]
         ) -> Tuple[ctypes.CDLL, Any]:
    """(library, C entry point ``entry`` of ``csrc/<stem>.cu``), its
    argument types set and returning an int, bound once.  Give every
    pointer and the stream as ``ctypes.c_void_p``."""
    got = _ENTRIES.get((stem, entry))
    if got is None:
        lib = load(stem)
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        got = _ENTRIES[(stem, entry)] = (lib, fn)
    return got


def launch(fn: Any, device: torch.device, *args: Any) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream (its raw
    handle); enters ``torch.cuda.device`` only when ``device`` is not the
    current one.  Returns the entry point's error code."""
    current = torch.cuda.current_device()
    if device.index in (None, current):
        return fn(*args, torch._C._cuda_getCurrentRawStream(current))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))


def sass(stem: str) -> str:
    """The SASS of the library built from ``csrc/<stem>.cu``
    (``cuobjdump -sass``, from the toolkit beside ``nvcc``)."""
    load(stem)
    tool = Path(nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library_path(stem))],
                          check=True, capture_output=True, text=True).stdout
