"""Data substrate of the port: the procedural digit dataset and the
synthetic LM token stream (byte copies of ``repro.data.digits`` and
``repro.data.tokens``) and the host input pipeline."""

from . import digits, pipeline, tokens

__all__ = ["digits", "pipeline", "tokens"]
