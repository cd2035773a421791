"""The guard against JAX, and that a run imports none of it."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from perfbench import manifest
from perfbench.guard import FORBIDDEN, jax_modules

HERE = manifest.HERE


def test_compares_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "optax": 1,
            "flax.linen": 1, "lp_gnn_tpu.models": 1, "lp_gnn_tpu": 1,
            "lp_gnn_tpu_torch": 1, "lp_gnn_tpu_torch.train": 1,
            "jaxtyping": 1, "torch": 1}
    assert jax_modules(mods) == ["flax.linen", "jax", "jax.numpy",
                                 "jaxlib.xla", "lp_gnn_tpu",
                                 "lp_gnn_tpu.models", "optax"]


def imports_of(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_and_the_reference_none_of_the_program():
    for path in HERE.rglob("*.py"):
        assert not imports_of(path) & FORBIDDEN, path
    for path in (HERE / "reference").rglob("*.py"):
        assert "lp_gnn_tpu_torch" not in imports_of(path), path


def test_a_run_loads_no_jax():
    """A tiny run on the CPU in a fresh process, then the guard."""
    code = (
        "import torch\n"
        "from perfbench.tests.conftest import tiny_cell\n"
        "from perfbench import run\n"
        "from perfbench.guard import jax_modules\n"
        "line = run.run_cell(tiny_cell('gcn_fc_h1024.lp1m', hids=16),\n"
        "                    2**31 + 5, 0.2, True, torch.device('cpu'))\n"
        "assert line['attempted'] > 0\n"
        "print('JAX', jax_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX []" in out.stdout
