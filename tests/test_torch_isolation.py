"""The port stands alone: nothing under ``src/repro_torch/``, in
``chip_smoke.py``, in the port's examples or in its contract checker
(``tools/spjoin_lint_torch/``) imports JAX, the JAX package or the
reference's checker ``spjoin_lint``, and the package loads in a process
where importing ``jax`` fails."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "spjoin_lint")
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("*_torch.py"))
         + sorted((ROOT / "tools" / "spjoin_lint_torch").glob("*.py")))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "from repro_torch import convert\n"
        "from repro_torch.core import baselines, distributed, index, spjoin, verify\n"
        "from repro_torch.kernels import compact, histogram, ops\n"
        "from repro_torch.data import dedup, pipeline, synthetic, vectorize\n"
        "from repro_torch import configs, models, train\n"
        "assert len({configs.get(n).name for n in configs.ARCH_NAMES}) == 10\n"
        "from repro_torch.models import attention, base, collectives, config, layers, moe, ssm, transformer, xlstm\n"
        "from repro_torch.train import checkpoint, optimizer, train_step\n"
        "from repro_torch.launch import dryrun, dryrun_opt, mesh, serve, shardings, stepcount, train\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "from repro_torch.data.pipeline import PipelineConfig, TokenPipeline\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
