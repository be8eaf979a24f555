"""Build and load the port's native libraries (``csrc/``).

Two routes, one per source kind:

- a CUDA kernel source ``csrc/<name>.cu`` is compiled by ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface;
- a host source ``csrc/<name>.cpp`` (the greedy committer) is compiled by
  the host C++ compiler (``$CXX``, else ``c++``) with ``-O3 -std=c++17
  -shared -fPIC``.

Each source gets its own compiler process (all processes start together),
under ``build/tamp_tpu_torch/`` at the repository root, at first use.  The
file name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is loaded as is.  The libraries are bound
with ``ctypes``.  For a kernel (:func:`launch`) every pointer and the
stream are passed as ``c_void_p`` (a Python int from ``tensor.data_ptr()``
or ``stream.cuda_stream``), every C entry returns ``cudaGetLastError()``
after its launch, and :func:`check` raises on a non-zero code.

Nothing here runs at import: the CPU tests import every module, and a
build is only started by a wrapper handed a CUDA tensor, by the greedy
committer's first call (engine/greedy.py), or by ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "build_all", "check", "launch", "SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tamp_tpu_torch"
SOURCES = ("match_ext", "encode_commit", "decode_commit", "decode_wavefront",
           "decode_serial", "greedy_predict", "greedy_commit")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: dict[str, str] = {}  # ptxas report of each built source


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "c++"))
    if found is None:
        raise RuntimeError("no host C++ compiler: set CXX or put c++ on PATH")
    return found


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` (a kernel) or ``csrc/<name>.cpp`` (host code)."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: Path) -> list[str]:
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def _target(name: str) -> Path:
    src = _source(name)
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one compiler process per source, in
    parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        src = _source(name)
        cc = _nvcc() if src.suffix == ".cu" else _cxx()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *_flags(src), "-o", str(tmp), str(src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp`` (built on first
    use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def launch(name: str, entry: str, device, pointers, ints) -> None:
    """Call the C entry ``entry`` of ``csrc/<name>.cu`` on ``device``'s
    current stream: ``pointers`` (tensors, or None for a null pointer),
    then the ``ints``, then the stream; raise if the launch failed.  The
    caller keeps the tensors alive and contiguous."""
    import torch

    fn = getattr(load(name), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(pointers)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    ptrs = [None if p is None else p.data_ptr() for p in pointers]
    with torch.cuda.device(device):
        rc = fn(*ptrs, *ints, torch.cuda.current_stream(device).cuda_stream)
    check(rc, f"{entry} kernel")
