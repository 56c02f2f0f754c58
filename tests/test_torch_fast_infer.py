"""Port parity: the folded-BN bf16 forward
(``ssp_torch.models.fast_infer.make_fast_apply``) against the JAX
package's ``make_fast_apply(..., interpret=True, use_packed=True)`` — the
Pallas stem and, at B ≤ 4, the Pallas down1 in interpret mode — with the
trained weights of ``evidence/wsem_weights.npz``, at B=2, 64×96.

Both sides round at the same points (bf16 input, bf16 weights, fp32
accumulation and epilogues, bf16 activations between layers), so they
differ only where an fp32 sum taken in another order flips a bf16
rounding; such a flip moves the next layer's inputs by one bf16 ulp.

Bars, each with its reason:
* semi: max abs ≤ two bf16 ulps at the largest |semi| — one flipped
  rounding of the bf16 head output plus the drift carried up through ten
  bf16 layers;
* desc: min cosine ≥ 0.9999 — descriptors are unit vectors, compared by
  direction; a handful of one-ulp flips among 256 bf16 channels;
* sem: max abs ≤ 1% of the largest |sem| — fp32 logits of a bf16 input
  whose own flips the 1×1 conv sums over 256 channels.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.models.fast_infer import make_fast_apply as j_make_fast_apply
from ssp_torch.models.fast_infer import fast_apply_fn, fold_bn, fold_variables, make_fast_apply
from ssp_torch.models.weights import load_flax_npz

NPZ = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"
H, W = 64, 96


def _flax_variables(name):
    tree = {}
    with np.load(NPZ) as data:
        for key in data.files:
            if name == "SuperPointNet_gauss2" and key.split("/")[1] in ("convDS", "convSout"):
                continue
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(data[key])
    return tree


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("name", ["SuperPointNet_gauss2_ssmall", "SuperPointNet_gauss2"])
def test_fast_forward_matches_jax_fast_forward(name):
    x = np.random.default_rng(0).uniform(size=(2, H, W, 1)).astype(np.float32)
    want = j_make_fast_apply(_flax_variables(name), input_hw=(H, W), interpret=True,
                             use_packed=True)(jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in want.items()}
    model = load_flax_npz(NPZ, name, device="cpu")
    got = {k: v.numpy() for k, v in make_fast_apply(model, device="cpu")(torch.from_numpy(x)).items()}

    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    semi_scale = np.abs(want["semi"]).max()
    assert np.abs(got["semi"] - want["semi"]).max() <= 2 * _bf16_ulp(semi_scale)
    assert (got["desc"] * want["desc"]).sum(-1).min() >= 0.9999
    if "sem" in want:
        sem_err = np.abs(got["sem"] - want["sem"]).max()
        assert sem_err <= 0.01 * np.abs(want["sem"]).max()


def test_fold_bn_matches_flax_batchnorm():
    """The folded epilogue equals inference BN applied after the conv."""
    rng = np.random.default_rng(1)
    g, b, m = (torch.from_numpy(rng.normal(size=8).astype(np.float32)) for _ in range(3))
    v = torch.from_numpy(rng.uniform(0.5, 2.0, 8).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    s, sb = fold_bn(g, b, m, v)
    torch.testing.assert_close(y * s + sb, (y - m) / torch.sqrt(v + 1e-5) * g + b,
                               rtol=1e-6, atol=1e-6)


def test_fold_variables_layout():
    model = load_flax_npz(NPZ, "SuperPointNet_gauss2_ssmall", device="cpu")
    folded = fold_variables(model)
    assert set(folded) == {"inc0", "inc1", "d1a", "d1b", "d2a", "d2b", "d3a", "d3b",
                           "pa", "pb", "da", "db", "ds", "sout"}
    w, s, b = folded["inc0"]
    assert w.shape == (3, 3, 1, 64) and w.dtype == torch.bfloat16
    assert s.dtype == b.dtype == torch.float32
    assert folded["sout"][0].shape == (1, 1, 256, 133)
    assert "ds" not in fold_variables(load_flax_npz(NPZ, "SuperPointNet_gauss2", device="cpu"))


def test_fast_apply_fn_and_fp32_module_agree():
    """The one-shot drop-in equals ``make_fast_apply``, and the bf16 path
    stays near the fp32 module (the bars of the JAX package's own
    ``tests/test_fast_infer.py``: semi < 0.15, desc cosine > 0.999)."""
    model = load_flax_npz(NPZ, "SuperPointNet_gauss2", device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(1, H, W, 1)).astype(np.float32))
    a = fast_apply_fn(model, x)
    b = make_fast_apply(model, device="cpu")(x)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    with torch.no_grad():
        ref = model(x)
    assert (a["semi"] - ref["semi"]).abs().max() < 0.15
    assert (a["desc"] * ref["desc"]).sum(-1).min() > 0.999
    with pytest.raises(ValueError, match="inference-only"):
        fast_apply_fn(model, x, train=True)
    with pytest.raises(ValueError, match="multiples of 8"):
        make_fast_apply(model, device="cpu")(x[:, :60])
