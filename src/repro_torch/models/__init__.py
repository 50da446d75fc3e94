"""Model zoo of the port: shared layers, attention, FFN/MoE, Mamba-2 SSD,
and the unified transformer covering every assigned architecture family
(port of ``repro.models``)."""

from . import attention, ffn, layers, mamba, transformer
from .transformer import Transformer, init_cache, lm_apply, lm_init

__all__ = ["attention", "ffn", "layers", "mamba", "transformer",
           "Transformer", "init_cache", "lm_apply", "lm_init"]
