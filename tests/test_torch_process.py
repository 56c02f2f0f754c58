"""Port parity for ``ssp_torch.postprocess.process.SuperPointProcess``
against ``ssp.postprocess.process.SuperPointProcess`` (batched NMS,
soft-argmax offsets, fixed-N feature extraction) on seeded heatmaps and
coarse descriptors.

Bars: NMS maps, points and validity exact (max/compare and the same
top-k order, ties lowest index first); offsets to atol 1e-5 (an fp32
softmax expectation over a 5×5 patch, in pixels up to 4, in two libraries:
the bar of ``test_torch_ha.py::test_soft_argmax_refine_matches_jax``);
descriptors to atol 1e-5 (fp32
bilinear blend and renormalisation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.postprocess.process import SuperPointProcess as JProcess
from ssp_torch.postprocess.process import SuperPointProcess

B, H, W, D = 3, 48, 64, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    heat = (rng.uniform(size=(B, H, W)) ** 6).astype(np.float32)
    heat[0, 10:14, 20:24] = 0.5  # a plateau of ties
    desc = rng.normal(size=(B, H // 8, W // 8, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return heat, desc


@pytest.mark.parametrize("k,nms_dist,conf", [(40, 4, 0.015), (100, 2, 0.0), (10, 1, 0.3)])
def test_superpoint_process_matches_jax(k, nms_dist, conf):
    heat, desc = _inputs(k)
    jp = JProcess(out_num_points=k, patch_size=5, nms_dist=nms_dist, conf_thresh=conf)
    tp = SuperPointProcess(out_num_points=k, patch_size=5, nms_dist=nms_dist, conf_thresh=conf)

    want_nms = np.asarray(jp.heatmap_to_nms(jnp.asarray(heat)))
    got_nms = tp.heatmap_to_nms(torch.from_numpy(heat))
    np.testing.assert_array_equal(got_nms.numpy(), want_nms)

    want = {k_: np.asarray(v) for k_, v in
            jp.pred_soft_argmax(jnp.asarray(want_nms), jnp.asarray(heat)).items()}
    got = {k_: v.numpy() for k_, v in tp.pred_soft_argmax(got_nms, torch.from_numpy(heat)).items()}
    np.testing.assert_array_equal(got["pts"], want["pts"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=0, atol=1e-5)

    res = np.array(want["pred"])  # writable, for torch.from_numpy
    want_f = {k_: np.asarray(v) for k_, v in jp.batch_extract_features(
        jnp.asarray(desc), jnp.asarray(want_nms), jnp.asarray(res)).items()}
    got_f = {k_: v.numpy() for k_, v in tp.batch_extract_features(
        torch.from_numpy(desc), got_nms, torch.from_numpy(res)).items()}
    assert set(got_f) == set(want_f)
    np.testing.assert_array_equal(got_f["pts_int"], want_f["pts_int"])
    np.testing.assert_array_equal(got_f["valid"], want_f["valid"])
    np.testing.assert_array_equal(got_f["pts_offset"], want_f["pts_offset"])
    np.testing.assert_allclose(got_f["pts_desc"], want_f["pts_desc"], rtol=0, atol=1e-5)
    assert got_f["pts_desc"].shape == (B, k, D)
