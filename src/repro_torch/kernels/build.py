"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. On first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``<repo>/build/repro_torch/``,
under a file name keyed by a hash of the source and the flags, and loaded
with ``ctypes``. A later process finds the library and skips the build.
``ptxas``'s report of each kernel's registers, shared memory and spills
(``-Xptxas -v``) is kept beside the library (:func:`ptxas_report`). No
source links ``libcuda``: the flash kernel reaches the driver's
``cuTensorMapEncodeTiled`` through the runtime's driver entry point.
Nothing is compiled at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "PLAIN_DEVICES",
           "library_path",
           "ptxas_report", "build", "build_all", "load_library"]

SOURCES = ("adel_agg", "flash_attention", "ssd_scan")

# the device types on which a kernel's wrapper computes its plain version:
# the CPU (the tests), and ``meta`` (the dry run's shapes; nothing is
# computed there). A CUDA tensor launches the kernel; any other device raises
PLAIN_DEVICES = ("cpu", "meta")

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` keeps ``ptxas -v``'s output."""
    return library_path(name).with_suffix(".ptxas.txt")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists.
    The library is written under a temporary name and renamed into place,
    so a process racing this build never loads a half-written file."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    ptxas_report(name).write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(names=SOURCES) -> dict:
    """Build every named source at once, one ``nvcc`` process each, all
    started together; returns {name: library path}."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)))
