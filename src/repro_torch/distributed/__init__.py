"""Device meshes for the serving engines and the LM's logical-axis sharding
rules (port of ``repro.distributed``'s mesh constructors and rules)."""
