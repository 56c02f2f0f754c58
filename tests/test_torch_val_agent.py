"""Port parity: ``Val_model_heatmap`` (``ssp_torch.train.val_agent.ValAgent``)
against the JAX package's ``ValAgent`` on the trained weights of
``evidence/wsem_weights.npz`` (``SuperPointNet_gauss2_ssmall``, 133 classes),
``fast_inference: false`` at fp32 on both sides, on seeded 48×64 images.
Without the soft-argmax the keypoints are equal, with it within 1e-4 px;
the descriptors within 1e-5 and the heatmap within 2e-4 (the fp32 forward
bar).  The registry resolves the three agent names of this module and
``ssp_torch/train/subpixel_agent.py`` as the train CLI imports them."""

import numpy as np
import pytest

from ssp.train.val_agent import ValAgent as JValAgent
from ssp_torch import registry
from ssp_torch.bench import structured_images
from ssp_torch.cli import train as _cli  # noqa: F401  (registers the agent names)
from ssp_torch.train.subpixel_agent import SubpixelTrainAgent, SubpixelValAgent
from ssp_torch.train.val_agent import ValAgent
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

NPZ = "evidence/wsem_weights.npz"
H, W = 48, 64


def _config(subpixel):
    return {"model": {"name": "SuperPointNet_gauss2_ssmall",
                      "params": {"n_classes": 133, "dtype": "float32"},
                      "fast_inference": False, "detection_threshold": 0.015, "nms": 4,
                      "top_k": 100, "subpixel": {"enable": subpixel, "patch_size": 5}},
            "pretrained": NPZ}


@pytest.mark.parametrize("subpixel", [False, True])
def test_val_agent_matches_jax(subpixel):
    cfg = _config(subpixel)
    jagent = JValAgent(cfg, input_hw=(H, W))
    agent = ValAgent(cfg, input_hw=(H, W), device="cpu")
    for img in structured_images(2, H, W, 5)[..., 0]:
        want, got = jagent.run(img), agent.run(img)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        jp, tp = jagent.heatmap_to_pts(), agent.heatmap_to_pts()
        assert len(tp) == len(jp) >= 5
        if subpixel:
            np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=1e-5)
        else:
            np.testing.assert_array_equal(tp[:, :2], jp[:, :2])
            np.testing.assert_allclose(tp[:, 2], jp[:, 2], atol=2e-4, rtol=0)
        np.testing.assert_allclose(agent.desc_to_sparseDesc(), jagent.desc_to_sparse_desc(),
                                   atol=1e-5, rtol=0)


def test_val_agent_paths_and_registry():
    assert registry.get("agent", "Val_model_heatmap") is ValAgent
    assert registry.get("agent", "Val_model_subpixel") is SubpixelValAgent
    assert registry.get("agent", "Train_model_subpixel") is SubpixelTrainAgent
    img = structured_images(1, H, W, 6)[0, ..., 0]
    cfg = _config(False)
    cfg["model"]["fast_inference"] = True
    fast = ValAgent(cfg, input_hw=(H, W), device="cpu")
    plain = ValAgent(cfg, input_hw=(H, W), device="cpu", reference=True)
    np.testing.assert_array_equal(fast.run(img), plain.run(img))
    np.testing.assert_array_equal(fast.heatmap_to_pts(), plain.heatmap_to_pts())
    agent = ValAgent({"model": {"name": "SuperPointNet_gauss2"}}, input_hw=(H, W), device="cpu")
    agent.init_random()
    heat = agent.run(img)
    assert heat.shape == (H, W) and np.isfinite(heat).all()
    assert agent.desc_to_sparse_desc().shape[1:] == (256,)
    agent.loadModel(NPZ)  # a semantic checkpoint read as gauss2 drops its semantic head
    assert np.isfinite(agent.run(img)).all()
