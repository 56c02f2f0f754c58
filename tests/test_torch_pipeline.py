"""Port parity for the whole slice: ``ssp_torch.bench.build_pipeline`` on
the CPU against the JAX composition that ``bench.py --export-grade``
measures — JAX fast forward (Pallas stem and down1 in interpret mode) →
``flatten_detection`` → ``nms_pallas(interpret=True, radius=4,
border=4)`` → ``lax.top_k`` → ``vmap(sample_descriptors)`` — with the
trained weights of ``evidence/wsem_weights.npz`` and K=50.

* Fed the same heatmap and coarse descriptors, the post-processing is
  deterministic integer/compare work plus one bilinear blend: the same
  points, in the same order (ties lowest index first), exactly; the
  descriptors to atol 1e-5 (fp32 blend and renormalisation).
* End to end, the two bf16 forwards differ by flipped bf16 roundings
  (see ``test_torch_fast_infer.py``), which reorder near-tied tail
  scores: every point the JAX side scores at or above the reference's
  0.015 confidence threshold is found, at least 90% of all K points
  agree (the bar of the JAX package's own keypoint-agreement test), and
  descriptors at shared points agree to cosine ≥ 0.999.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.core.grid import flatten_detection
from ssp.kernels.nms_pallas import nms_pallas
from ssp.models.fast_infer import make_fast_apply
from ssp.postprocess.points import sample_descriptors
from ssp_torch.bench import build_pipeline, postprocess, structured_images
from ssp_torch.models.weights import load_flax_npz

NPZ = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"
H, W, K = 64, 96, 50
CONF = 0.015


@pytest.fixture(scope="module")
def jax_pipeline():
    tree = {}
    with np.load(NPZ) as data:
        for key in data.files:
            if key.split("/")[1] in ("convDS", "convSout"):
                continue
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(data[key])
    fast = make_fast_apply(tree, input_hw=(H, W), interpret=True, use_packed=True)

    def run(x):
        out = fast(jnp.asarray(x))
        heat = flatten_detection(out["semi"])[..., 0]
        nmsed = nms_pallas(heat, radius=4, border=4, interpret=True)
        scores, idx = jax.lax.top_k(nmsed.reshape(nmsed.shape[0], -1), K)
        pts = jnp.stack([(idx % W).astype(jnp.float32), (idx // W).astype(jnp.float32),
                         scores], axis=-1)
        desc = jax.vmap(sample_descriptors)(out["desc"], pts)
        return np.asarray(heat), np.asarray(out["desc"]), np.asarray(pts), np.asarray(desc)

    return run


@pytest.fixture(scope="module")
def port_pipeline():
    return build_pipeline(load_flax_npz(NPZ, "SuperPointNet_gauss2", device="cpu"), "cpu", k=K)


def _images(kind, seed):
    if kind == "noise":
        return np.random.default_rng(seed).uniform(size=(2, H, W, 1)).astype(np.float32)
    return structured_images(2, H, W, seed)


@pytest.mark.parametrize("kind", ["noise", "structured"])
def test_postprocess_identical_on_same_heatmap(jax_pipeline, kind):
    heat, coarse, want_pts, want_desc = jax_pipeline(_images(kind, 0))
    pts, desc = postprocess(torch.from_numpy(heat.copy()), torch.from_numpy(coarse.copy()), k=K)
    assert pts.shape == (2, K, 3) and desc.shape == (2, K, 256)
    np.testing.assert_array_equal(pts.numpy(), want_pts)
    np.testing.assert_allclose(desc.numpy(), want_desc, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_end_to_end_agreement(jax_pipeline, port_pipeline, seed):
    x = _images("structured", seed)
    _, _, want_pts, want_desc = jax_pipeline(x)
    pts, desc = port_pipeline(torch.from_numpy(x))
    pts, desc = pts.numpy(), desc.numpy()
    for b in range(2):
        want = {tuple(p[:2].astype(int)): i for i, p in enumerate(want_pts[b]) if p[2] > 0}
        got = {tuple(p[:2].astype(int)): i for i, p in enumerate(pts[b]) if p[2] > 0}
        strong = np.array([xy for xy, i in want.items() if want_pts[b, i, 2] >= CONF])
        near = np.abs(strong[:, None, :] - np.array(list(got))[None]).max(-1).min(1)
        assert len(strong) and near.max() <= 4, near
        shared = set(want) & set(got)
        assert len(shared) >= 0.9 * max(len(want), len(got)), (len(want), len(got), len(shared))
        cos = [float(want_desc[b, want[xy]] @ desc[b, got[xy]]) for xy in shared]
        assert min(cos) >= 0.999, min(cos)


def test_top_k_ties_lowest_index_first():
    from ssp_torch.postprocess.points import top_k

    x = torch.tensor([[0.0, 3.0, 1.0, 3.0, 0.0, 1.0, 0.0]])
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 6)
    v, i = top_k(x, 6)
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    assert i.tolist() == [[1, 3, 2, 5, 0, 4]]


@pytest.mark.parametrize("border", [0, 4])
def test_extract_keypoints_matches_jax(border):
    """Per-image keypoint extraction (NMS → border → top-k → confidence
    mask): the same points in the same order, the same validity mask."""
    from ssp.postprocess.points import extract_keypoints as j_extract
    from ssp_torch.postprocess.points import extract_keypoints

    heat = (np.random.default_rng(border).uniform(size=(48, 64)) ** 6).astype(np.float32)
    heat[10:14, 20:24] = 0.5  # a plateau of ties
    want_pts, want_valid = j_extract(jnp.asarray(heat), k=40, border=border)
    pts, valid = extract_keypoints(torch.from_numpy(heat), k=40, border=border)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(want_pts))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


def test_batched_nms_matches_jax():
    from ssp.postprocess.nms import batched_nms as j_batched_nms
    from ssp_torch.postprocess.nms import batched_nms

    heat = (np.random.default_rng(9).uniform(size=(3, 40, 56)) ** 4).astype(np.float32)
    want = np.asarray(j_batched_nms(jnp.asarray(heat), 4, border=4))
    np.testing.assert_array_equal(batched_nms(torch.from_numpy(heat), 4, border=4).numpy(), want)
