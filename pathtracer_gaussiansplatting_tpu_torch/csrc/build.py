"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Counterpart of ``pathtracer_gaussiansplatting_tpu/csrc/build.py`` (which
builds the reference's host-side C++ helpers). Here one ``nvcc`` per
``csrc/*.cu`` file, all started together, compiles each (with its plain C
entry point) for Hopper (``sm_90a``); one more links the objects into a
shared library, and ``ctypes`` loads it. Nothing includes PyTorch's
headers, so a build takes seconds.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC_DIR.glob("*.cuh"))


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
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libptgs_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds, env) -> list:
    """Start every command at once; (returncode, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for c in cmds]
    outs = [pr.communicate()[0] for pr in procs]
    return [(pr.returncode, out) for pr, out in zip(procs, outs)]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    nvcc = nvcc_path()
    # nvcc's intermediate files stay inside the build directory.
    env = dict(os.environ, TMPDIR=str(BUILD_DIR))
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(sources(), objs)]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
            *(str(o) for o in objs)]
    steps = list(zip(compiles, _run_all(compiles, env)))
    if all(rc == 0 for _, (rc, _) in steps):
        steps += list(zip([link], _run_all([link], env)))
    lib.with_suffix(".log").write_text("".join(
        " ".join(cmd) + "\n" + out for cmd, (_, out) in steps))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(cmd, rc, out) for cmd, (rc, out) in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed with code {rc} on "
                           f"{Path(cmd[-1]).name}:\n{out[-4000:]}")
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
