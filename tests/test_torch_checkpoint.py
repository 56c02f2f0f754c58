"""Port parity for weights named by a config's ``pretrained``:
``ssp_torch.models.weights.load_torch_checkpoint`` against
``ssp.models.weights.load_torch_checkpoint`` on the three payloads a
reference checkpoint comes in, written with ``torch.save`` from a seeded
port model; and ``load_weights`` for each kind of path.  Bars: the same
keys, equal arrays, the same ``n_iter``; loaded models equal the saved
one exactly."""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from ssp.models.weights import load_torch_checkpoint as j_load_torch_checkpoint
from ssp_torch.cli.export import _load_model
from ssp_torch.models import build_model
from ssp_torch.models.weights import load_flax_npz, load_torch_checkpoint, load_weights
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

NPZ = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"
NAME = "SuperPointNet_gauss2_ssmall"
SPLIT = {"model_enc": ("inc.", "down"), "model_semi": ("convP", "bnP"),
         "model_desc": ("convD", "bnD"), "model_sem": ("convDS", "bnS", "convSout")}


@pytest.fixture(scope="module")
def model():
    return build_model(NAME, device="cpu", generator=torch.Generator().manual_seed(3), n_classes=5)


def _payload(kind, sd):
    if kind == "model_state_dict":
        return {"model_state_dict": sd, "n_iter": 1234, "loss": 0.5}
    if kind == "split":
        subs = {}
        for key, v in sd.items():
            part = next(p for p, prefixes in SPLIT.items()
                        if key.startswith(prefixes) and not
                        (p == "model_desc" and key.startswith(("convDS", "bnS"))))
            subs.setdefault(part, {})[key] = v
        return {**subs, "n_iter": 77}
    return sd


@pytest.mark.parametrize("kind", ["model_state_dict", "split", "bare"])
def test_load_torch_checkpoint_matches_jax(tmp_path, model, kind):
    sd = model.state_dict()
    path = tmp_path / "ckpt.pth.tar"
    torch.save(_payload(kind, sd), path)
    want, want_iter = j_load_torch_checkpoint(str(path))
    got, got_iter = load_torch_checkpoint(path)
    assert got_iter == want_iter == {"model_state_dict": 1234, "split": 77, "bare": 0}[kind]
    assert set(got) == set(want) == set(sd)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    loaded = load_weights(path, NAME, {"n_classes": 5}, device="cpu")
    for key, v in loaded.state_dict().items():
        assert torch.equal(v, sd[key]), key
    assert not loaded.training


def test_load_weights_npz_and_refusals(tmp_path):
    got = load_weights(NPZ, NAME, {"n_classes": 133}, device="cpu")
    want = load_flax_npz(NPZ, NAME, device="cpu")
    assert all(torch.equal(v, want.state_dict()[k]) for k, v in got.state_dict().items())
    with pytest.raises(ValueError, match="133 classes"):
        load_weights(NPZ, NAME, {"n_classes": 5}, device="cpu")
    with pytest.raises(ValueError, match="JAX package"):
        load_weights(tmp_path, NAME, device="cpu")


def test_cli_model_without_pretrained_is_seeded(caplog):
    config = {"model": {"name": NAME, "params": {"n_classes": 7}}}
    with caplog.at_level(logging.WARNING, logger="ssp_torch.cli.export"):
        a = _load_model(config, device="cpu")
    assert "no pretrained weights configured" in caplog.text
    b = _load_model(config, device="cpu")
    assert a.n_classes == 7
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    loaded = _load_model({"model": {"name": NAME, "params": {"n_classes": 133}},
                          "pretrained": str(NPZ)}, device="cpu")
    assert loaded.n_classes == 133
