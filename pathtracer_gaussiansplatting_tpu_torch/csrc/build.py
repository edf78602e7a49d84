"""Build and load the port's native code: the CUDA kernels (nvcc) and the
host-side C++ helpers (g++), each a shared library loaded with ctypes.

Counterpart of ``pathtracer_gaussiansplatting_tpu/csrc/build.py`` (which
builds the reference's host-side C++ helpers). For the kernels, one
``nvcc`` per ``csrc/*.cu`` file, all started together, compiles each (with
its plain C entry point) for Hopper (``sm_90a``); one more links the
objects into a shared library. Nothing includes PyTorch's headers, so a
build takes seconds. The host helpers (``csrc/*.cpp``: the grid binning
and the point-cloud PLY rows) are one ``g++ -O3 -shared -fPIC`` call (:func:`build_host`); they run on
any machine with ``g++``, the CPU tests' included.

The libraries go to ``csrc/_build/`` (listed in ``.gitignore``) under names
hashed from the sources and flags: the first call in a fresh checkout
builds, later calls load. ptxas's report (registers, shared memory, spills)
is kept beside the kernel library in a ``.log`` file. A failed build
raises; nothing falls back to a slower path.
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
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_HOST_LIB = None


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


def host_sources() -> list:
    return sorted(CSRC_DIR.glob("*.cpp"))


def _hashed(stem: str, flags, files) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _hashed("libptgs_kernels", NVCC_FLAGS, sources() + headers())


def host_library_path() -> Path:
    return _hashed("libptgs_host", HOST_FLAGS, host_sources())


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


def build_host() -> Path:
    """Compile the host helpers with g++ unless a library for these sources
    exists."""
    lib = host_library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
    cmd = ["g++", *HOST_FLAGS, "-o", str(tmp),
           *(str(s) for s in host_sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {res.returncode}:\n"
                           f"{(res.stdout + res.stderr)[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load_host() -> ctypes.CDLL:
    """The host helper library, built at first use and loaded once."""
    global _HOST_LIB
    if _HOST_LIB is None:
        _HOST_LIB = ctypes.CDLL(str(build_host()))
    return _HOST_LIB
