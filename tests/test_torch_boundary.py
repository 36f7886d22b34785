"""The port stands alone: nothing under src/repro_torch/ nor chip_smoke.py
imports jax, jaxlib or the reference package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_imports(path):
    bad = sorted({root for root in _imported_roots(path) if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.models, repro_torch.serving, repro_torch.convert\n"
        "import repro_torch.kernels.flash_decode, repro_torch.kernels.int8_matmul\n"
        "import repro_torch.training.checkpoint, repro_torch.core.calibration, repro_torch.core.stats\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.training.optimizer, repro_torch.training.trainer, repro_torch.training.data\n"
        "import repro_torch.parallel, repro_torch.parallel.sharding, repro_torch.parallel.collectives\n"
        "import repro_torch.launch.mesh, repro_torch.models.spmd\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=str(REPO))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
