"""Port parity: ``ssp_torch.cli.import_torch`` and ``ssp_torch.cli.convert2script``
against the JAX package's CLIs on the CPU, from seeded weights.

* Import: a reference-format state dict written from a flax initialisation
  (its BatchNorm statistics drawn at random) by
  ``ssp.models.weights.export_torch_gauss2`` goes through the JAX
  ``import_checkpoint`` and through the port's; the two forwards agree at
  the flagship's fp32 bars (2e-4 on semi and desc, 2e-3 on sem,
  ``tests/test_weight_import.py``), the port's result loaded as every CLI's
  ``pretrained:`` loads it and through ``load_checkpoint``; the output is
  named by ``n_iter``.  The Sener split payload imports as the joint state
  dict does, a MagicLeap ``.pth`` as ``SuperPointNet_pretrained``, and a
  missing, extra or misshapen tensor raises naming it before anything is
  written.
* Deployment: ``export_model`` at 1×48×64, fp32, on the same npz weights as
  the JAX ``export_model``; the loaded ``torch.export`` program against
  ``jax.export.deserialize(...).call`` of the JAX artifact at the same bars,
  with and without ``keep_sem``.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.cli.import_torch import import_checkpoint as j_import_checkpoint
from ssp.models import build_model as j_build_model
from ssp.models.weights import export_torch_gauss2
from ssp.train.checkpoint import load_checkpoint as j_load_checkpoint
from ssp.train.state import create_train_state
from ssp_torch.cli import convert2script, import_torch
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import load_weights, save_weights_npz
from ssp_torch.train import TrainState
from ssp_torch.train.checkpoint import load_checkpoint
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

SSMALL = "SuperPointNet_gauss2_ssmall"
HW = (32, 48)
BARS = {"semi": 2e-4, "desc": 2e-4, "sem": 2e-3}


def _jax_reference(tmp_path: Path, n_classes: int = 133):
    """(the flax module, its state with random BatchNorm statistics, the
    reference ``.pth.tar`` of those weights with ``n_iter`` 123)."""
    jm = j_build_model(SSMALL, dtype=jnp.float32, n_classes=n_classes)
    state = jax.jit(lambda key: create_train_state(jm, key, (1, *HW, 1)))(jax.random.key(0))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
                         if v.ndim else v, state.batch_stats)
    state = state.replace(batch_stats=stats)
    sd = export_torch_gauss2(state.params, state.batch_stats)
    ckpt = tmp_path / "ref.pth.tar"
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "n_iter": 123}, ckpt)
    return jm, state, ckpt


def _port_forward(model, x):
    with torch.no_grad():
        return {k: v.numpy() for k, v in model.eval()(torch.from_numpy(x)).items()}


def _close(got: dict, want: dict, keys):
    for k in keys:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=BARS[k], err_msg=k)


def test_import_matches_jax_import(tmp_path):
    jm, state, ckpt = _jax_reference(tmp_path)
    jout = j_import_checkpoint(ckpt, tmp_path / "jax", SSMALL, 133, HW)
    jstate = j_load_checkpoint(jout, state, mode="weights")
    out = import_torch.import_checkpoint(ckpt, tmp_path / "port", SSMALL, 133, HW)
    assert out.name == "superPointNet_123.pth.tar" and jout.name == "superPointNet_123"
    assert (out.parent / "superPointNet_123.npz").exists()

    x = np.random.default_rng(1).uniform(size=(2, *HW, 1)).astype(np.float32)
    want = {k: np.asarray(v) for k, v in jax.jit(functools.partial(jm.apply, train=False))(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, jnp.asarray(x)).items()}
    # every CLI's ``pretrained:`` (load_weights) and the trainer's load_checkpoint
    _close(_port_forward(load_weights(out, SSMALL, {"n_classes": 133}, device="cpu"), x),
           want, BARS)
    ts = TrainState.create(build_model(SSMALL, device="cpu", n_classes=133))
    load_checkpoint(out, ts, mode="full")
    assert ts.step == 123
    _close(_port_forward(ts.model, x), want, BARS)


def test_import_cli_sener_split_and_mismatches(tmp_path):
    _, _, ckpt = _jax_reference(tmp_path, n_classes=7)
    sd = torch.load(ckpt)["model_state_dict"]
    joint = import_torch.main([str(ckpt), str(tmp_path / "joint"), "--n-classes", "7",
                               "--height", "32", "--width", "48"])
    groups = {"model_enc": ("inc", "down1", "down2", "down3"),
              "model_semi": ("convPa", "bnPa", "convPb", "bnPb"),
              "model_desc": ("convDa", "bnDa", "convDb", "bnDb"),
              "model_sem": ("convDS", "bnS1", "convSout")}
    sener = {g: {k: v for k, v in sd.items() if k.split(".")[0] in p} for g, p in groups.items()}
    torch.save(dict(sener, n_iter=7), tmp_path / "sener.pth.tar")
    split = import_torch.import_checkpoint(tmp_path / "sener.pth.tar", tmp_path / "split", SSMALL,
                                           7, HW)
    assert split.name == "superPointNet_7.pth.tar"
    a = torch.load(joint)["model_state_dict"]
    b = torch.load(split)["model_state_dict"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k

    bad = dict(sd)
    bad.pop("convDb.bias")
    bad["convX.weight"] = torch.zeros(3)
    bad["convPb.weight"] = torch.zeros(64, 256, 1, 1)
    torch.save({"model_state_dict": bad, "n_iter": 5}, tmp_path / "bad.pth.tar")
    with pytest.raises(ValueError) as e:
        import_torch.import_checkpoint(tmp_path / "bad.pth.tar", tmp_path / "never", SSMALL, 7, HW)
    assert "convDb.bias" in str(e.value) and "convX.weight" in str(e.value)
    assert "convPb.weight" in str(e.value)
    assert not (tmp_path / "never").exists()
    with pytest.raises(ValueError, match="convSout"):  # the class count is checked too
        import_torch.import_checkpoint(ckpt, tmp_path / "never", SSMALL, 133, HW)


def test_import_magicleap_pth(tmp_path):
    ml = build_model("SuperPointNet_pretrained", device="cpu",
                     generator=torch.Generator().manual_seed(2))
    torch.save(ml.state_dict(), tmp_path / "superpoint_v1.pth")
    out = import_torch.import_checkpoint(tmp_path / "superpoint_v1.pth", tmp_path / "ml",
                                         "SuperPointNet_pretrained", 133, HW)
    assert out.name == "superPointNet_0.pth.tar"
    x = np.random.default_rng(3).uniform(size=(1, *HW, 1)).astype(np.float32)
    got = load_weights(out, "SuperPointNet_pretrained", device="cpu")
    for k, v in ml.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    want = _port_forward(ml, x)
    for k, v in _port_forward(got, x).items():
        np.testing.assert_array_equal(v, want[k])


@pytest.mark.parametrize("keep_sem", [False, True], ids=["no-sem", "keep-sem"])
def test_convert_matches_jax_export(tmp_path, keep_sem):
    from jax import export as jexport

    from ssp.cli.convert2script import export_model as j_export_model

    model = build_model(SSMALL, device="cpu", n_classes=7,
                        generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(len(name)))
    npz = save_weights_npz(tmp_path / "w.npz", model)
    cfg = {"model": {"name": SSMALL, "params": {"n_classes": 7}}, "pretrained": str(npz)}
    jcfg = {"model": {"name": SSMALL, "params": {"n_classes": 7, "dtype": jnp.float32}},
            "pretrained": str(npz)}
    jcfg_out = j_export_model(jcfg, tmp_path / "m.stablehlo", 1, 48, 64, keep_sem=keep_sem)
    cfg["model"]["params"]["dtype"] = "float32"
    out = convert2script.main([_yaml(tmp_path, cfg), str(tmp_path / "m.pt2"), "--height", "48",
                               "--width", "64", "--device", "cpu"]
                              + (["--keep-sem"] if keep_sem else []))
    program = torch.export.load(out).module()

    x = np.random.default_rng(5).uniform(size=(1, 48, 64, 1)).astype(np.float32)
    want = jexport.deserialize(jcfg_out.read_bytes()).call(jnp.asarray(x))
    with torch.no_grad():
        got = program(torch.from_numpy(x))
    names = ("semi", "desc", "sem") if keep_sem else ("semi", "desc")
    assert len(got) == len(want) == len(names)
    _close({k: v.numpy() for k, v in zip(names, got)},
           {k: np.asarray(v) for k, v in zip(names, want)}, names)
    assert got[0].shape == (1, 6, 8, 65) and got[1].shape == (1, 6, 8, 256)


def _yaml(tmp_path: Path, cfg: dict) -> str:
    import yaml

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)
