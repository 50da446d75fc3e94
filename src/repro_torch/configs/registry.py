"""Config registry: ``get_config(name)`` / ``get_reduced(name)`` / list.

Every assigned architecture registers an :class:`ArchConfig` here; the
paper's own model (snn-mnist) is a separate family handled by
``configs.snn_mnist``.  :data:`PORT_ONLY` names the architectures the JAX
package does not have.
"""

from __future__ import annotations

from .base import ArchConfig, SHAPES, reduced

__all__ = ["register", "get_config", "get_reduced", "list_archs", "SHAPES",
           "shape_cells", "cell_is_live", "PORT_ONLY"]

# the architectures only the port registers
PORT_ONLY = ("nemotron-3-nano-30b-a3b",)

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_reduced(name: str, **kw) -> ArchConfig:
    return reduced(get_config(name), **kw)


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


# Archs that can run the 524k-token decode cell (sub-quadratic context):
# SSM (O(1) state) and the mamba-dominated hybrid.  Pure full-attention
# archs skip it (DESIGN.md §7).
LONG_CONTEXT_OK = {"mamba2-1.3b", "jamba-v0.1-52b"}


def cell_is_live(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True


def shape_cells() -> list[tuple[str, str]]:
    """All 40 (arch, shape) cells; use cell_is_live to filter runnable ones."""
    _ensure_loaded()
    return [(a, s) for a in list_archs() if _REGISTRY[a].family != "snn"
            for s in SHAPES]


_loaded = False


def _ensure_loaded():
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import (arctic_480b, dbrx_132b, gemma2_9b,  # noqa: F401
                   jamba_v01_52b, llama3_8b, llava_next_34b,  # noqa: F401
                   mamba2_1p3b, nemotron_3_nano_30b,  # noqa: F401
                   nemotron_4_340b, qwen3_4b, snn_mnist,  # noqa: F401
                   whisper_small)  # noqa: F401
