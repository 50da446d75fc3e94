"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the ``repro`` package, and
importing the port loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in _FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.convert,"
            " repro_torch.configs.snn_mnist, repro_torch.kernels.ops,"
            " repro_torch.distributed.sharding,"
            " repro_torch.kernels.spike_matmul, repro_torch.core.train_snn,"
            " repro_torch.core.conversion, repro_torch.data.digits,"
            " repro_torch.optim, repro_torch.models, repro_torch.configs,"
            " repro_torch.serve.engine, repro_torch.launch.serve,"
            " repro_torch.train, repro_torch.checkpoint,"
            " repro_torch.optim.compression,"
            " repro_torch.distributed.partition, repro_torch.launch.train,"
            " repro_torch.data.tokens, repro_torch.launch.specs,"
            " repro_torch.launch.mesh, repro_torch.launch.op_cost,"
            " repro_torch.launch.dryrun, repro_torch.launch.recost;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
