"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the repository
root (``build/`` is git-ignored). The hash is of the source and the shared
``csrc/*.cuh`` headers, so an edited source or header never reuses a stale
library. :func:`build` starts one ``nvcc`` per source, all at once, and
waits for them together; :func:`load` builds on first use; :func:`launch`
calls a loaded entry point on a card's current stream. Nothing here runs
at import time: the CPU tests import every module of the port on machines
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("ds_estep", "entropy", "flash_attention", "flash_attention_bwd",
           "linear_scan", "ordered_sum", "xent")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
# nvcc's output per source (``-Xptxas -v``: registers, shared memory and
# spills of every kernel), kept for the smoke run to print
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu``, named by a hash of the
    source, every ``csrc/*.cuh`` header (any of which it may include) and
    the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every source in ``names`` that has no up-to-date library,
    one ``nvcc`` process each, started together. Returns name -> path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    nvcc = _nvcc() if todo else None
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _libs[name] = lib
    return lib


def _stream(index: int) -> int:
    """PyTorch's current stream on card ``index``, as an integer handle."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(fn, dev: torch.device, *args) -> int:
    """Call the C entry point ``fn(*args, stream)`` with card ``dev``
    current, ``stream`` being PyTorch's current stream there as one
    integer; returns ``fn``'s error code. ``torch.cuda.device`` is entered
    only when ``dev`` is not the current card already."""
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        return fn(*args, _stream(index))
    with torch.cuda.device(index):
        return fn(*args, _stream(index))
