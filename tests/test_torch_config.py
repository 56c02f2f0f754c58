"""Port parity for configs and experiment directories:
``ssp_torch.utils.config`` and ``ssp_torch.utils.experiment`` against the
JAX package's, for every config file of the repo.  Bars: equal dicts,
equal directory layouts, equal ``config.yml`` bytes."""

import copy
import importlib.util
from pathlib import Path

import pytest

from ssp.utils.config import dict_update as j_dict_update
from ssp.utils.config import load_config as j_load_config
from ssp.utils.experiment import ExperimentPaths as JExperimentPaths
from ssp.utils.experiment import settings_paths as j_settings_paths
from ssp_torch.utils.config import dict_update, load_config
from ssp_torch.utils.experiment import ExperimentPaths, settings_paths
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
DEFAULTS = {"model": {"nms": 3, "subpixel": {"enable": False, "patch_size": 7}},
            "data": {"preprocessing": {"resize": [120, 160]}}, "seed": 1}


def test_configs_found():
    assert len(CONFIGS) > 30


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
@pytest.mark.parametrize("defaults", [None, DEFAULTS], ids=["plain", "defaults"])
def test_load_config_matches_jax(path, defaults):
    before = copy.deepcopy(DEFAULTS)
    assert load_config(path, defaults) == j_load_config(path, defaults)
    assert DEFAULTS == before  # the defaults are copied, never merged into


def test_dict_update_matches_jax():
    u = {"a": {"b": 2, "c": {"d": None}}, "e": [1, 2], "f": {"g": 1}}
    for base in ({}, {"a": {"b": 1, "x": 0}, "f": None}, {"a": {"c": {"d": 4, "y": 5}}}):
        assert dict_update(copy.deepcopy(base), u) == j_dict_update(copy.deepcopy(base), u)


def test_experiment_paths_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "jax"))
    assert {k: str(v) for k, v in j_settings_paths().items()} == \
        {"DATA_PATH": str(tmp_path / "data"), "EXPER_PATH": str(tmp_path / "jax")}
    want = JExperimentPaths("exp/one")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "port"))
    assert settings_paths()["EXPER_PATH"] == tmp_path / "port"
    got = ExperimentPaths("exp/one")
    for attr in ("root", "checkpoints", "predictions"):
        assert getattr(got, attr).relative_to(tmp_path / "port") == \
            getattr(want, attr).relative_to(tmp_path / "jax")
    tree = lambda r: sorted(p.relative_to(r).as_posix() for p in r.rglob("*"))  # noqa: E731
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    config = {**load_config(CONFIGS[0]), "path": tmp_path, "shape": (1, 2)}
    want.dump_config(config)
    got.dump_config(config)
    assert (got.root / "config.yml").read_bytes() == (want.root / "config.yml").read_bytes()
    explicit = ExperimentPaths("two", exper_path=tmp_path / "elsewhere")
    assert explicit.checkpoints.is_dir() and explicit.root == tmp_path / "elsewhere" / "two"


def test_chip_smoke_config_is_the_sweep_config():
    """The HPatches phase of ``chip_smoke.py`` carries its config as a dict
    (the card's Python may lack PyYAML): it must be
    ``configs/pipeline240_sweep_wsem.yaml`` plus the trained weights."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = load_config(ROOT / "configs" / "pipeline240_sweep_wsem.yaml")
    want["pretrained"] = "evidence/wsem_weights.npz"
    assert smoke.HPATCHES_CONFIG == want


@pytest.mark.parametrize("name,config_file", [
    ("SEQUENCE_CONFIG", "kitti384_sequence_r5.yaml"),
    ("HA_CLI_CONFIG", "magicpoint_coco_export.yaml"),
])
def test_chip_smoke_export_configs_are_the_shipped_configs(name, config_file):
    """The sequence and stage-2 phases of ``chip_smoke.py`` carry their
    configs as dicts: the shipped files, with the trained weights."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = load_config(ROOT / "configs" / config_file)
    want["pretrained"] = "evidence/wsem_weights.npz"
    assert getattr(smoke, name) == want
