"""The PyTorch port stands alone: no module of ``ssp_torch`` and not
``chip_smoke.py`` imports ``jax``, ``flax``, the JAX package ``ssp``
(importing any ``ssp`` module runs ``ssp/__init__.py``, which loads flax),
``cv2``, ``sklearn``, ``PIL`` or ``tensorflow`` (the machine with the card has neither
OpenCV nor scikit-learn nor Pillow: the port decodes images itself)."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ssp", "cv2", "sklearn", "PIL",
             "tensorflow"}
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
    assert {"ssp_torch/bench_ha.py", "ssp_torch/core/homography.py",
            "ssp_torch/export/homography_adaptation.py", "ssp_torch/kernels/vresample.py",
            "ssp_torch/kernels/warp_twopass.py"} <= names
    assert {"ssp_torch/utils/config.py", "ssp_torch/utils/experiment.py",
            "ssp_torch/data/base.py", "ssp_torch/data/hpatches.py",
            "ssp_torch/postprocess/tracker.py", "ssp_torch/postprocess/process.py",
            "ssp_torch/export/descriptors_export.py", "ssp_torch/cli/export.py"} <= names
    assert {"ssp_torch/evaluations/__init__.py", "ssp_torch/evaluations/detector.py",
            "ssp_torch/evaluations/descriptor.py", "ssp_torch/evaluations/semantic.py",
            "ssp_torch/evaluations/matching.py", "ssp_torch/evaluations/homography_fit.py",
            "ssp_torch/cli/evaluate.py", "ssp_torch/cli/export_eval.py"} <= names
    assert {"ssp_torch/data/imageio.py", "ssp_torch/data/kitti.py",
            "ssp_torch/data/coco.py"} <= names
    assert {"ssp_torch/data/photometric.py", "ssp_torch/data/pipeline.py",
            "ssp_torch/data/coco_labels.py", "ssp_torch/data/prefetch.py",
            "ssp_torch/data/device_corpus.py",
            "ssp_torch/losses/detector.py", "ssp_torch/losses/descriptor_sparse.py",
            "ssp_torch/losses/semantic.py", "ssp_torch/losses/multitask.py",
            "ssp_torch/train/lr.py", "ssp_torch/train/state.py", "ssp_torch/train/step.py",
            "ssp_torch/train/checkpoint.py", "ssp_torch/train/trainer.py",
            "ssp_torch/cli/train.py"} <= names
    assert {"ssp_torch/data/raster.py", "ssp_torch/data/synthetic_shapes.py",
            "ssp_torch/data/synthetic_dataset.py"} <= names
    assert {"ssp_torch/losses/descriptor_dense.py", "ssp_torch/losses/subpixel.py",
            "ssp_torch/models/subpixel.py", "ssp_torch/train/subpixel_agent.py",
            "ssp_torch/train/val_agent.py", "ssp_torch/utils/draw.py"} <= names
    assert {"ssp_torch/native/__init__.py", "ssp_torch/cli/import_torch.py",
            "ssp_torch/cli/convert2script.py", "ssp_torch/parallel/__init__.py",
            "ssp_torch/parallel/mesh.py"} <= names
    assert {"ssp_torch/export/classical.py", "ssp_torch/export/features.py",
            "ssp_torch/kernels/bfmatch.py", "ssp_torch/cli/export_classical.py"} <= names
    assert {"ssp_torch/kernels/ordered_scatter.py", "ssp_torch/cli/eval_sequence.py",
            "ssp_torch/cli/eval_semantic.py", "ssp_torch/cli/run_export.py"} <= names
    assert {"ssp_torch/cli/make_coco_tree.py", "ssp_torch/cli/make_gt_labels.py",
            "ssp_torch/cli/make_coco_sem_labels.py", "ssp_torch/cli/make_synth_hpatches.py",
            "ssp_torch/cli/make_kitti_tree.py", "ssp_torch/data/corpus.py"} <= names
    assert len(names) >= 97


def test_fresh_interpreter_imports_every_module_without_jax_ssp_cv2():
    """Import ``ssp_torch`` and every module under it in a fresh interpreter:
    the imports bring none of the forbidden packages into ``sys.modules``
    (what the interpreter's own start-up hooks loaded is set aside), and
    build nothing."""
    mods = sorted(p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
                  .removesuffix(".__init__") for p in FILES if p.name != "chip_smoke.py")
    code = "\n".join([
        "import importlib, sys",
        "before = set(sys.modules)",
        f"for m in {mods!r}: importlib.import_module(m)",
        "new = {m.split('.')[0] for m in set(sys.modules) - before}",
        f"print('BAD', sorted(new & set({sorted(FORBIDDEN)!r})))",
        "print('IMPORTED', len([m for m in sys.modules if m.startswith('ssp_torch')]))",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert f"IMPORTED {len(mods)}" in r.stdout, (r.stdout, mods)


def test_package_data_ships_the_kernel_sources():
    text = (ROOT / "pyproject.toml").read_text()
    assert 'ssp_torch = ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp", "csrc/*.h"]' in text
    from ssp_torch.kernels import _build

    assert set(_build.SOURCES) == {p.stem for p in (ROOT / "ssp_torch" / "csrc").glob("*.cu")}
    assert set(_build.HOST_SOURCES) == {p.stem for p in (ROOT / "ssp_torch" / "csrc")
                                        .glob("*.cpp")}


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
