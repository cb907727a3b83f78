"""Build and load the CUDA kernels: nvcc into a plain-C shared library,
bound with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root,
keyed by a hash of every source in ``csrc/`` and the flags, so an edited
kernel rebuilds and an unchanged one loads straight away.  Nothing is
compiled at import: the CPU path never needs nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "load", "build_log"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: One shared library per source file.
SOURCES = ("bfp_matmul", "bfp_conv", "bfp_quantize")

# -fmad=false: every float multiply and add rounds on its own, as in the
# JAX reference.  No --use_fast_math: it flushes subnormals, and a BFP
# step is subnormal for small blocks (the zero-block step is 2^-132).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_log(name: str) -> str:
    """nvcc/ptxas output of the current build of ``name`` ('' if none)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library of ``names``, one nvcc per source,
    all started together; returns the seconds each build took (0.0 for
    one already built).  Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, times = {}, {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            times[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)        # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
