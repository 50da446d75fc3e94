"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``, the device meshes they run over,
and the dry-run tooling: abstract inputs on ``meta`` (``specs``), an
op-level cost counter (``op_cost``), ``python -m
repro_torch.launch.dryrun`` and ``python -m repro_torch.launch.recost``."""
