"""Build the port's CUDA kernels on first use and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), named by a hash of its source and flags, under
``build/repro_torch/`` at the root of the checkout, with nvcc's output
(the ``-Xptxas -v`` resource report) saved beside it as ``.log``.  The
sources are compiled in parallel, one ``nvcc`` each.  A failed build raises
with the compiler's output.  Nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["SOURCES", "BuildInfo", "build_all", "load_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"fused_snn_stack": _CSRC / "fused_snn_stack.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    name: str
    path: Path
    seconds: float      # wall time of the nvcc run (0.0 when cached)
    log: str            # nvcc's output, incl. -Xptxas -v resource usage
    cached: bool        # the library was already built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on "
                           "PATH or set CUDA_HOME")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, BuildInfo]:
    """Compile every (or the named) kernel source that is not built yet.

    All compilers start together; raises RuntimeError naming each source
    that failed, with its compiler output.
    """
    names = list(SOURCES if names is None else names)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    infos, running = {}, {}
    for name in names:
        out = _target(name)
        log_path = out.with_suffix(".log")
        if out.exists():
            log = log_path.read_text() if log_path.exists() else ""
            infos[name] = BuildInfo(name, out, 0.0, log, True)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{SOURCES[name].name}:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        infos[name] = BuildInfo(name, out, seconds, log, False)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return infos


@functools.lru_cache(maxsize=None)
def load_library(name: str = "fused_snn_stack") -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, its C functions typed."""
    lib = ctypes.CDLL(str(build_all([name])[name].path))
    if name == "fused_snn_stack":
        fn = lib.repro_fused_snn_stack
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib
