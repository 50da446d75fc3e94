"""Hand-written CUDA kernels of the port, their launchers and their plain
PyTorch versions.  Nothing is compiled at import: ``_build`` compiles a
kernel on its first launch."""
