"""Port parity: the port's ``SuperPointGauss2`` ``nn.Module`` with weights
carried across from the JAX package.

The trained full-width artifact ``evidence/wsem_weights.npz`` (flax keys,
fp32, ``SuperPointNet_gauss2_ssmall`` with 133 classes) loads into the
flax model at ``dtype=float32`` and into the port; both run inference
(flax ``train=False``, torch ``eval()``) on the same numpy input.

Bars (those of ``tests/test_weight_import.py``): atol 2e-4 on semi and
desc, 2e-3 on sem — fp32 convolutions through ten layers summed in
different orders by XLA and by PyTorch; sem is ×8 upsampled logits of
larger magnitude.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.models import build_model as j_build_model
from ssp.models.weights import export_torch_gauss2
from ssp_torch.models import build_model
from ssp_torch.models.weights import (
    flax_to_state_dict,
    load_flax_npz,
    load_reference_state_dict,
)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

NPZ = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"


def _flax_variables(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


@pytest.fixture(scope="module")
def npz():
    with np.load(NPZ) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", ["SuperPointNet_gauss2_ssmall", "SuperPointNet_gauss2"])
def test_forward_parity_trained_weights(npz, name):
    semantic = name.endswith("ssmall")
    flat = npz if semantic else {k: v for k, v in npz.items()
                                 if "/convDS/" not in k and "/convSout/" not in k}
    kw = {"n_classes": 133} if semantic else {}
    jmodel = j_build_model(name, dtype=jnp.float32, **kw)
    x = np.random.default_rng(0).uniform(size=(2, 32, 48, 1)).astype(np.float32)
    want = jax.jit(functools.partial(jmodel.apply, train=False))(_flax_variables(flat),
                                                                  jnp.asarray(x))

    model = load_flax_npz(NPZ, name, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))

    assert set(got) == set(want)
    np.testing.assert_allclose(got["semi"].numpy(), np.asarray(want["semi"]), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["desc"].numpy(), np.asarray(want["desc"]), atol=2e-4, rtol=0)
    if semantic:
        np.testing.assert_allclose(got["sem"].numpy(), np.asarray(want["sem"]), atol=2e-3, rtol=0)


def test_gauss2_drops_semantic_scopes(npz):
    model = load_flax_npz(NPZ, "SuperPointNet_gauss2", device="cpu")
    names = set(model.state_dict())
    assert not any(n.startswith(("convDS", "bnS1", "convSout")) for n in names)
    full = load_flax_npz(NPZ, "SuperPointNet_gauss2_ssmall", device="cpu")
    assert full.n_classes == 133 and full.convSout.weight.shape == (133, 256, 1, 1)
    # the shared layers carry identical values
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, full.state_dict()[k], rtol=0, atol=0)


def test_load_is_strict(npz):
    missing = {k: v for k, v in npz.items() if k != "params/convPa/Conv_0/bias"}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_npz(missing, "SuperPointNet_gauss2_ssmall", device="cpu")
    extra = dict(npz)
    extra["params/convXX/Conv_0/kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(KeyError, match="convXX"):
        load_flax_npz(extra, "SuperPointNet_gauss2_ssmall", device="cpu")


@pytest.mark.parametrize("name", ["SuperPointNet_gauss2_ssmall", "SuperPointNet_gauss2"])
def test_export_torch_gauss2_loads_strictly(npz, name):
    """The JAX package's reference-layout exporter feeds the port's model
    through a strict ``load_state_dict``, giving the same tensors as the
    flax-npz path."""
    semantic = name.endswith("ssmall")
    tree = _flax_variables(npz)
    params, stats = tree["params"], tree["batch_stats"]
    if not semantic:
        params = {k: v for k, v in params.items() if k not in ("convDS", "convSout")}
        stats = {k: v for k, v in stats.items() if k != "convDS"}
    sd = export_torch_gauss2(params, stats)
    model = build_model(name, device="cpu", **({"n_classes": 133} if semantic else {}))
    load_reference_state_dict(model, sd)
    via_npz = load_flax_npz(NPZ, name, device="cpu").state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, via_npz[k], rtol=0, atol=0)


def test_flax_to_state_dict_layout(npz):
    sd = flax_to_state_dict(npz)
    k = npz["params/down1/ConvBNRelu_1/Conv_0/kernel"]  # HWIO
    np.testing.assert_array_equal(sd["down1.mpconv.1.conv.3.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["bnS1.running_var"].numpy(), npz["batch_stats/convDS/BatchNorm_0/var"])
    assert len(sd) == len(npz) == 80


def test_build_model_generator_init_is_seeded():
    a = build_model("SuperPointNet_gauss2", device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model("SuperPointNet_gauss2", device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    lim = (6.0 / (64 * 9)) ** 0.5  # He-uniform bound of a 64→64 3×3 conv
    w = a.state_dict()["down1.mpconv.1.conv.0.weight"]
    assert w.abs().max() <= lim and w.abs().max() > 0.9 * lim


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("SuperPointNet_gauss2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_flax_npz(NPZ, "SuperPointNet_gauss2")
