"""Data substrate of the port: the procedural digit dataset (a copy of
``repro.data.digits``) and the host input pipeline."""

from . import digits, pipeline

__all__ = ["digits", "pipeline"]
