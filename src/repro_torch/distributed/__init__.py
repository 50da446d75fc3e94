"""Device meshes for the serving engines (port of ``repro.distributed``'s
mesh constructors)."""
