"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Counterpart of ``pathtracer_gaussiansplatting_tpu/csrc/build.py`` (which
builds the reference's host-side C++ helpers). Here ``nvcc`` compiles every
``csrc/*.cu`` file, each with a plain C entry point, into one shared library
for Hopper (``sm_90a``), and ``ctypes`` loads it. Nothing includes
PyTorch's headers, so a build takes seconds.

The library goes to ``csrc/_build/`` (listed in ``.gitignore``) under a name
hashed from the sources and flags: the first call in a fresh checkout
builds, later calls load. ptxas's report (registers, shared memory, spills)
is kept beside it in a ``.log`` file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libptgs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources())]
    # nvcc's intermediate files stay inside the build directory.
    env = dict(os.environ, TMPDIR=str(BUILD_DIR))
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         check=False)
    lib.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def build_log() -> str:
    """nvcc's command and ptxas's report for the current library."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB
