"""The port's MagicLeap SuperPoint (``SuperPointNet_pretrained``) against
the JAX package's flax module at ``dtype=float32``.

``superpoint_v1.pth`` is not in the repository, so seeded numpy weights in
the reference's layout stand in for it.  They go through the JAX importer
``ssp.models.weights.import_torch_magicleap`` into the flax module, and
into the port three ways: a strict ``load_state_dict``, the importer's
params saved as a flax npz read by ``load_weights``, and a bare ``.pth``
state dict read by ``load_weights``.  Bar: atol 2e-4 on ``semi`` and
``desc`` at 64×96 (the fp32 forward bar of the port's other parity tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.models.superpoint import SuperPointMagicLeap as JaxMagicLeap
from ssp.models.weights import import_torch_magicleap
from ssp_torch.bench import structured_images
from ssp_torch.models.fast_infer import best_apply_fn, supports_fast
from ssp_torch.models.superpoint import SuperPointMagicLeap, build_model
from ssp_torch.models.weights import load_reference_state_dict, load_weights
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

H, W = 64, 96
ATOL = 2e-4
LAYERS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3), ("conv2a", 64, 64, 3),
          ("conv2b", 64, 64, 3), ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
          ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3), ("convPa", 128, 256, 3),
          ("convPb", 256, 65, 1), ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))


def _seeded_state_dict(seed=0):
    """Reference-layout (OIHW) weights with He-normal scales and nonzero
    biases."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, cin, cout, k in LAYERS:
        sd[f"{name}.weight"] = rng.normal(0, (2.0 / (cin * k * k)) ** 0.5,
                                          (cout, cin, k, k)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.05, cout).astype(np.float32)
    return sd


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def reference():
    sd = _seeded_state_dict()
    params, _ = import_torch_magicleap(sd)
    x = structured_images(2, H, W, 3)
    out = JaxMagicLeap(dtype=jnp.float32).apply({"params": params}, jnp.asarray(x))
    return sd, params, x, {k: np.asarray(v) for k, v in out.items()}


def _check(model, x, want):
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("semi", "desc"):
        assert got[key].shape == want[key].shape, key
        err = float(np.abs(got[key].numpy() - want[key]).max())
        print(f"{key}: max abs err {err:.3g}")
        assert err <= ATOL, key


def test_forward_matches_flax_through_the_state_dict(reference):
    sd, _, x, want = reference
    model = build_model("SuperPointNet_pretrained", device="cpu")
    assert isinstance(model, SuperPointMagicLeap)
    assert set(model.state_dict()) == set(sd)
    load_reference_state_dict(model, sd)
    _check(model, x, want)
    assert want["semi"].shape == (2, H // 8, W // 8, 65)
    np.testing.assert_allclose(np.linalg.norm(want["desc"], axis=-1), 1.0, atol=1e-5)


def test_forward_matches_flax_through_both_files(reference, tmp_path):
    sd, params, x, want = reference
    npz = tmp_path / "magicleap.npz"
    np.savez(npz, **_flatten(params, "params"))
    assert "params/conv1a/kernel" in np.load(npz).files
    _check(load_weights(npz, "SuperPointNet_pretrained", device="cpu"), x, want)
    pth = tmp_path / "superpoint_v1.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    _check(load_weights(pth, "SuperPointNet_pretrained", device="cpu"), x, want)
    # strict: a missing tensor raises
    torch.save({k: torch.from_numpy(v) for k, v in sd.items() if k != "convDb.bias"}, pth)
    with pytest.raises(RuntimeError, match="convDb.bias"):
        load_weights(pth, "SuperPointNet_pretrained", device="cpu")


def test_best_apply_fn_gives_the_fp32_module():
    model = build_model("SuperPointNet_pretrained", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert not supports_fast(model)
    assert best_apply_fn(model, input_hw=(240, 320), device="cpu") is model


def test_export_descriptor_writes_the_jax_layout(tmp_path, monkeypatch):
    """A 2-pair CPU ``export_descriptor`` with ``SuperPointNet_pretrained``
    and seeded weights from a bare ``.pth``: the JAX package's npz keys and
    dtypes, finite values, 256-wide descriptors."""
    from test_torch_export import KEYS, _make_tree

    from ssp_torch.cli.export import export_descriptor

    _make_tree(tmp_path / "hp", n_seq=1)
    pth = tmp_path / "superpoint_v1.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _seeded_state_dict(1).items()}, pth)
    config = {"data": {"name": "patches_dataset", "dataset": "hpatches", "alteration": "all",
                       "root": str(tmp_path / "hp"), "preprocessing": {"resize": [H, W]}},
              "model": {"name": "SuperPointNet_pretrained", "detection_threshold": 0.0,
                        "nms": 4, "top_k": 100, "nn_thresh": 1.0,
                        "subpixel": {"enable": True, "patch_size": 5}},
              "pretrained": str(pth)}
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    assert export_descriptor(config, "ml", device="cpu") == 2
    for i in range(2):
        with np.load(tmp_path / "logs" / "ml" / "predictions" / f"{i}.npz") as z:
            assert set(z.files) == KEYS
            assert z["prob"].dtype == np.float32 and z["desc"].dtype == np.float32
            assert z["desc"].shape[1] == 256 and len(z["prob"]) > 0
            assert np.isfinite(z["desc"]).all() and z["matches"].shape[1] == 4
