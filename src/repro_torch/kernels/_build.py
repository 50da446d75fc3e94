"""Build the port's CUDA kernels on first use, load them with ctypes, and
launch them.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), named by a hash of its source, the shared headers and the
flags, under ``build/repro_torch/`` at the root of the checkout, with
nvcc's output (the ``-Xptxas -v`` resource report) saved beside it as
``.log``.  The sources are compiled in parallel, one ``nvcc`` each.  A
failed build raises with the compiler's output.  Nothing is compiled at
import.

Every library exports one entry point with the same C signature,
``int entry(void** ptrs, int n_ptrs, int* ints, int n_ints, void*
stream)``, which checks its operands, launches on ``stream`` and returns
the launch's ``cudaError_t``; :func:`launch` calls it and raises on a
non-zero return.
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

import torch

__all__ = ["SOURCES", "BuildInfo", "build_all", "load_library", "launch",
           "check_operand", "check_tallies"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"fused_snn_stack": _CSRC / "fused_snn_stack.cu",
           "fused_snn_streamed": _CSRC / "fused_snn_streamed.cu",
           "poisson_encode": _CSRC / "poisson_encode.cu",
           "lif_step": _CSRC / "lif_step.cu",
           "partial_contraction": _CSRC / "partial_contraction.cu",
           "spike_matmul": _CSRC / "spike_matmul.cu"}
_ENTRY = {"fused_snn_stack": "repro_fused_snn_stack",
          "fused_snn_streamed": "repro_fused_snn_streamed",
          "poisson_encode": "repro_poisson_encode",
          "lif_step": "repro_lif_forward",
          "partial_contraction": "repro_partial_contraction",
          "spike_matmul": "repro_spike_matmul"}
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
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, its C functions typed."""
    lib = ctypes.CDLL(str(build_all([name])[name].path))
    fn = getattr(lib, _ENTRY[name])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, ptrs, ints, device: torch.device) -> None:
    """Launch kernel ``name`` on ``device``'s current stream.

    ``ptrs`` are tensors (or None for a null pointer), ``ints`` Python
    ints, in the order the kernel's C entry point documents.  Raises
    RuntimeError when the entry point returns a CUDA error: a launch that
    was refused never ran.
    """
    lib = load_library(name)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(
        *[0 if t is None else t.data_ptr() for t in ptrs])
    c_ints = (ctypes.c_int * len(ints))(*ints)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, _ENTRY[name])(ctypes.addressof(c_ptrs), len(ptrs),
                                     ctypes.addressof(c_ints), len(ints),
                                     stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.repro_cuda_error_string(err).decode()})")


def check_operand(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has this dtype, shape and device and is
    contiguous (what every kernel's C entry point assumes)."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tallies(tallies, steps: int, lanes: int, device) -> None:
    """Raise unless ``tallies`` (``kernels.ops.StagedTallies``) are
    contiguous int32 tensors on ``device``, (steps, L, lanes) a lane and
    (steps, L, lanes / 8) a block: what the kernels add their tallies
    into."""
    n_layers = tallies.n_spk.shape[1] if tallies.n_spk.ndim == 3 else 0
    for name, t in zip(tallies._fields, tallies):
        per_block = name.startswith("live")
        want = (steps, n_layers, lanes // 8 if per_block else lanes)
        if (t.dtype != torch.int32 or tuple(t.shape) != want
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"tallies.{name} must be a contiguous int32 "
                             f"{want} tensor on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
