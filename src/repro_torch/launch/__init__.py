"""Launchers of the port: ``python -m repro_torch.launch.serve`` and the
local device mesh they run over."""
