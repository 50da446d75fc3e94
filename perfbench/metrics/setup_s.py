"""Set-up seconds: from the process's start (before ``import torch``)
until every shape of the cell is warm and the window starts: imports,
the CUDA context, the kernels' build or load, weights and inputs from the
seed, warm-up."""


def read(rec):
    return rec.get("setup_s")
