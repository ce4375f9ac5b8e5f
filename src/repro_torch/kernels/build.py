"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes`: no PyTorch headers, so a
build takes seconds. The libraries are named by a digest of their source
and the shared header, so an edited kernel rebuilds and an unchanged one
is reused. They go to ``REPRO_TORCH_KERNEL_DIR`` when it is set, else to
``_build/`` beside this file (listed in ``.gitignore``).

Nothing here runs at import time, so every module imports on a machine
without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

__all__ = ["SOURCES", "build", "build_dir", "check", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"

#: one shared library per kernel source
SOURCES: Tuple[str, ...] = ("popcnt_checksum", "dirty_diff", "flush_pack",
                            "apply_unpack")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_KERNEL_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / "blocks.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, *,
          verbose: bool = False) -> Dict[str, Tuple[float, str]]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once. Returns ``{name: (seconds, compiler
    output)}`` for the sources it built (``verbose`` adds ptxas's
    register and shared-memory report). Raises if any build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    done: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)   # atomic: concurrent builds agree
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def library(name: str,
            signatures: Dict[str, Sequence[type]]) -> ctypes.CDLL:
    """The loaded library of source ``name`` (built on first use), with
    each C entry's ``argtypes`` set from ``signatures`` and ``restype``
    int (every entry returns a ``cudaError_t``)."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build([name])
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
