"""The PyTorch port stands alone: no module of ``ssp_torch`` and not
``chip_smoke.py`` imports ``jax``, ``flax`` or the JAX package ``ssp``
(importing any ``ssp`` module runs ``ssp/__init__.py``, which loads flax)."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ssp"}
FILES = sorted((ROOT / "ssp_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names and "ssp_torch/bench.py" in names
    assert len(names) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_ssp_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """``chip_smoke.py`` prints no result and exits non-zero where it cannot
    drive the port on a card: in the checkout without CUDA, and alone in a
    directory without the rest of the repo."""
    import torch

    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [(lone, tmp_path)]
    if not torch.cuda.is_available():
        runs.append((ROOT / "chip_smoke.py", ROOT))
    for script, cwd in runs:
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0, (script, r.stdout, r.stderr)
        assert '"ok"' not in r.stdout, r.stdout
