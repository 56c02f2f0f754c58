"""Port parity for the slice as a whole: homography-adaptation export.

JAX ``make_ha_fn(model.apply, variables, num_h=4, top_k=50, chunk=3,
use_twopass=False)`` with keys ``k`` against the port's ``make_ha_fn`` fed
the homographies those keys give (``sample_homographies(k, num_h − 1,
shift=-1.0, **params)``; the port prepends the identity), both on the fp32
model with the trained weights of ``evidence/wsem_weights.npz``, gather
warp on both sides.

Bars: the two fp32 forwards agree to 2e-4 on semi
(``tests/test_torch_weights.py``), so the aggregated heatmaps differ by
about 1e-5 and only near-tied maxima can flip: at least 95% of the valid
keypoints of either side are found on the other within 1e-3 px (0 px
without subpixel refinement), with scores within 1e-4.

The port's two-pass HA against its gather HA is a comparison of two
interpolations, not of two implementations: two bilinear passes blur a
little differently from one bilinear gather, which moves weak maxima of
the aggregate by a pixel (the port's two-pass warp itself matches the JAX
package's to 2e-4, ``tests/test_torch_vresample.py``, and the JAX package's
own two HA variants share 79% and 93% of their points at the same pixel
on two 120×160 images).  Held here: at least 90% of the two-pass points
that score 0.05 or more are found by the gather HA within 3 px (the
repeatability metric's ε), and at least 65% of all valid points of either
at the same pixel.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.core.homography import sample_homographies as j_sample
from ssp.export.homography_adaptation import DEFAULT_HA as J_DEFAULT_HA
from ssp.export.homography_adaptation import make_ha_fn as j_make_ha_fn
from ssp.models import build_model as j_build_model
from ssp.postprocess.points import soft_argmax_refine as j_refine
from ssp_torch.bench import structured_images
from ssp_torch.export import DEFAULT_HA, make_ha_fn, run_ha_export
from ssp_torch.export.homography_adaptation import _image_generator
from ssp_torch.kernels import warp_twopass
from ssp_torch.models.fast_infer import best_apply_fn, supports_fast
from ssp_torch.models.weights import load_flax_npz
from ssp_torch.postprocess.points import soft_argmax_refine

NPZ = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"
H, W, NUM_H, TOP_K = 64, 96, 4, 50
PARAMS = DEFAULT_HA["homographies"]["params"]


@pytest.fixture(scope="module")
def jax_model():
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
    return j_build_model("SuperPointNet_gauss2", dtype=jnp.float32), tree


@pytest.fixture(scope="module")
def model():
    return load_flax_npz(NPZ, "SuperPointNet_gauss2", device="cpu")


def _matched(a_pts, a_valid, b_pts, b_valid, tol_px):
    """Share of a's valid points with a valid point of b within ``tol_px``,
    and the largest score difference among those pairs."""
    a, b = a_pts[a_valid], b_pts[b_valid]
    if not len(a):
        return 1.0, 0.0
    d = np.abs(a[:, None, :2] - b[None, :, :2]).max(-1)
    j = d.argmin(1)
    hit = d[np.arange(len(a)), j] <= tol_px
    ds = np.abs(a[hit, 2] - b[j[hit], 2]).max() if hit.any() else 0.0
    return hit.mean(), ds


def test_default_ha_is_the_jax_packages():
    assert DEFAULT_HA == J_DEFAULT_HA


@pytest.mark.parametrize("aggregation,filter_counts,subpixel",
                         [("sum", 0, True), ("max", 2, False)],
                         ids=["sum_subpixel", "max_filter_counts"])
def test_ha_matches_jax_with_injected_homographies(jax_model, model, aggregation,
                                                   filter_counts, subpixel):
    jmodel, variables = jax_model
    common = dict(num_h=NUM_H, top_k=TOP_K, chunk=3, use_twopass=False,
                  aggregation=aggregation, filter_counts=filter_counts, subpixel=subpixel)
    images = structured_images(2, H, W, 3)[..., 0]
    keys = jax.random.split(jax.random.key(7), 2)
    want_pts, want_valid = j_make_ha_fn(jmodel.apply, variables, **common)(keys, jnp.asarray(images))
    want_pts, want_valid = np.asarray(want_pts), np.asarray(want_valid)
    Hs = np.stack([np.array(j_sample(k, NUM_H - 1, shift=-1.0, **PARAMS)) for k in keys])

    ha = make_ha_fn(best_apply_fn(model, enable=False, device="cpu"), device="cpu", **common)
    pts, valid = ha(torch.from_numpy(images), homographies=torch.from_numpy(Hs))
    assert pts.shape == (2, TOP_K, 3) and valid.shape == (2, TOP_K)
    pts, valid = pts.numpy(), valid.numpy()
    tol = 1e-3 if subpixel else 0.0
    for g in range(2):
        assert want_valid[g].sum() >= 5
        for a, b in (((want_pts[g], want_valid[g]), (pts[g], valid[g])),
                     ((pts[g], valid[g]), (want_pts[g], want_valid[g]))):
            share, dscore = _matched(*a, *b, tol)
            assert share >= 0.95 and dscore <= 1e-4, (g, share, dscore)
    # an unbatched image gives the group's first result
    one_pts, one_valid = ha(torch.from_numpy(images[0]), homographies=torch.from_numpy(Hs[0]))
    np.testing.assert_allclose(one_pts.numpy(), pts[0], atol=1e-5)
    np.testing.assert_array_equal(one_valid.numpy(), valid[0])


def _twopass_against_gather_ha(model):
    images = torch.from_numpy(structured_images(2, H, W, 4)[..., 0])
    apply_fn = best_apply_fn(model, enable=False, device="cpu")
    common = dict(device="cpu", num_h=6, top_k=TOP_K, chunk=5)
    res = {}
    for twopass in (True, False):
        ha = make_ha_fn(apply_fn, use_twopass=twopass, **common)
        pts, valid = ha(images, generator=torch.Generator().manual_seed(11))
        res[twopass] = (pts.numpy(), valid.numpy())
    for g in range(2):
        a = (res[True][0][g], res[True][1][g])
        b = (res[False][0][g], res[False][1][g])
        assert a[1].sum() >= 5
        assert _matched(*a, *b, 0.0)[0] >= 0.65 and _matched(*b, *a, 0.0)[0] >= 0.65
        strong = a[1] & (a[0][:, 2] >= 0.05)
        assert strong.sum() >= 2 and _matched(a[0], strong, *b, 3.0)[0] >= 0.9


def test_twopass_ha_agrees_with_gather_ha(model):
    """The two-pass warp on its default route (coordinates rebuilt in the
    resample kernel from coefficients)."""
    assert warp_twopass.COEF_GRIDS
    _twopass_against_gather_ha(model)


def test_twopass_ha_on_the_rows_route_agrees_with_gather_ha(model, monkeypatch):
    monkeypatch.setattr(warp_twopass, "COEF_GRIDS", False)
    _twopass_against_gather_ha(model)


def test_ha_generators_and_argument_checks(model):
    apply_fn = best_apply_fn(model, enable=False, device="cpu")
    ha = make_ha_fn(apply_fn, device="cpu", num_h=3, top_k=20)
    images = torch.from_numpy(structured_images(2, H, W, 5)[..., 0])
    gens = lambda: [torch.Generator().manual_seed(s) for s in (1, 2)]
    a, b = ha(images, generator=gens()), ha(images, generator=gens())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # each image's result depends on its own generator only
    swapped = ha(images.flip(0), generator=gens()[::-1])
    assert torch.equal(swapped[0].flip(0), a[0])
    with pytest.raises(ValueError, match="generators"):
        ha(images, generator=gens()[:1])
    with pytest.raises(ValueError, match="homographies must be"):
        ha(images, homographies=torch.eye(3).expand(2, 5, 3, 3))
    with pytest.raises(ValueError, match="aggregation"):
        make_ha_fn(apply_fn, device="cpu", aggregation="mean")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA is not available (skipped: a card is present)")
        make_ha_fn(apply_fn)


def test_run_ha_export_writes_resumes_and_pads(model, tmp_path):
    ha = make_ha_fn(best_apply_fn(model, enable=False, device="cpu"), device="cpu",
                    num_h=3, top_k=30)
    images = [(f"img_{i}", structured_images(1, H, W, 20 + i)[0, ..., 0]) for i in range(5)]
    out = tmp_path / "out"
    # 5 images in groups of 2: the last group is padded and cut
    assert run_ha_export(ha, images, out, seed=3, group=2, depth=1) == 5
    files = sorted(p.name for p in out.iterdir())
    assert files == [f"img_{i}.npz" for i in range(5)]
    first = {n: np.load(out / f"{n}.npz")["pts"] for n, _ in images}
    for pts in first.values():
        assert pts.ndim == 2 and pts.shape[1] == 3 and 0 < len(pts) <= 30
        assert np.all(pts[:, 2] >= 0.015)
    # a second run finds everything done
    assert run_ha_export(ha, images, out, seed=3, group=2) == 0
    # a resumed run gives an image the homographies of a fresh one: remove
    # two files (the groups now form differently) and refill
    for n in ("img_1", "img_4"):
        (out / f"{n}.npz").unlink()
    assert run_ha_export(ha, images, out, seed=3, group=2) == 2
    for n in ("img_1", "img_4"):
        np.testing.assert_array_equal(np.load(out / f"{n}.npz")["pts"], first[n])
    # another seed gives other homographies
    other = tmp_path / "other"
    run_ha_export(ha, images[:1], other, seed=4, group=1)
    assert not np.array_equal(np.load(other / "img_0.npz")["pts"], first["img_0"])


def test_image_generator_is_keyed_by_seed_and_position():
    draw = lambda s, p: torch.rand(4, generator=_image_generator(s, p))
    assert torch.equal(draw(0, 5), draw(0, 5))
    assert not torch.equal(draw(0, 5), draw(0, 6))
    assert not torch.equal(draw(0, 5), draw(1, 5))


def test_soft_argmax_refine_matches_jax():
    rng = np.random.default_rng(8)
    heat = (rng.uniform(size=(2, 40, 56)) ** 3).astype(np.float32)
    heat[:, 10:13, 20:23] = 0.0  # an all-zero patch takes the log floor
    xy = np.stack([rng.integers(0, 56, (2, 30)), rng.integers(0, 40, (2, 30))], -1)
    xy[:, 0] = [0, 0]
    xy[:, 1] = [55, 39]  # corners: the window hangs over the zero padding
    xy[:, 2] = [21, 11]
    pts = np.concatenate([xy.astype(np.float32), rng.uniform(size=(2, 30, 1)).astype(np.float32)], -1)
    got = soft_argmax_refine(torch.from_numpy(heat), torch.from_numpy(pts)).numpy()
    for b in range(2):
        want = np.asarray(j_refine(jnp.asarray(heat[b]), jnp.asarray(pts[b])))
        np.testing.assert_allclose(got[b], want, atol=1e-5)
    np.testing.assert_array_equal(got[..., 2], pts[..., 2])


def test_best_apply_fn_choices(model):
    assert supports_fast(model) and supports_fast(model.state_dict())
    assert not supports_fast({"conv1a.weight": torch.zeros(1)})
    assert best_apply_fn(model, enable=False, device="cpu") is model
    fast = best_apply_fn(model, input_hw=(H, W), device="cpu")
    assert fast is not model
    x = torch.from_numpy(structured_images(1, H, W, 9))
    out = fast(x)
    assert out["semi"].shape == (1, H // 8, W // 8, 65)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA is not available (skipped: a card is present)")
        best_apply_fn(model)
