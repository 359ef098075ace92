"""The openpose annotator of the port against the JAX package and cv2 (CPU):
the body net on a seeded state dict at the published widths (1e-4), the
peak, limb and person assembly on the same maps (exact), the drawing and
its cv2 restatements (ellipse2Poly, fillConvexPoly, filled circle; exact),
the uint8 INTER_CUBIC resize by fx = fy (exact with cv2's own code, within
1 level of its IPP path), and the whole hint through ``run_annotator`` with
cv2's own resize code (every pixel)."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import openpose as jax_pose
from sdwebui_tpu.pipeline import annotators as jax_ann
from sdwebui_tpu_torch.models import openpose as pose
from sdwebui_tpu_torch.pipeline import annotators
from sdwebui_tpu_torch.utils import cv


@pytest.fixture
def no_ipp():
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


def _state_dict(seed=3):
    """A seeded body_pose_model.pth at the published widths whose last
    convs are scaled so the maps vary with the image: heatmaps around
    0.05 ± 0.15 (peaks above THRE1), PAFs around 0 ± 0.15."""
    sd = pose.body_pose_state_dict(pose.create_random_openpose(seed, "cpu"))
    img = _photo(96, 96, seed)
    heat, paf = pose.pose_maps(pose.openpose_from_state_dict(sd, "cpu"), img)
    for branch, maps, offset in ((2, heat, 0.05), (1, paf, 0.0)):
        gain = 0.15 / maps.std()
        sd[f"Mconv7_stage6_L{branch}.weight"] = sd[f"Mconv7_stage6_L{branch}.weight"] * gain
        sd[f"Mconv7_stage6_L{branch}.bias"] = (sd[f"Mconv7_stage6_L{branch}.bias"] * gain
                                               - maps.mean() * gain + offset)
    return sd


def _photo(h=128, w=96, seed=0):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return cv2.GaussianBlur(img, (0, 0), 6)


@pytest.fixture(scope="module")
def nets():
    sd = _state_dict()
    params = jax_pose.convert_openpose({k: v.numpy() for k, v in sd.items()})
    return sd, params, pose.openpose_from_state_dict(sd, "cpu")


def test_body_net_matches_jax(nets):
    sd, params, net = nets
    x = np.random.default_rng(5).random((1, 48, 40, 3)).astype(np.float32) - 0.5
    paf, heat = jax_pose.apply(params, jnp.asarray(x))
    with torch.no_grad():
        p, h = net(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert p.shape == (1, 38, 6, 5) and h.shape == (1, 19, 6, 5)
    for out, ref in ((p, paf), (h, heat)):
        ref = np.asarray(ref)
        err = np.abs(out.permute(0, 2, 3, 1).numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-6)
    carried = pose.openpose_from_jax(params)
    for k, v in carried.state_dict().items():
        assert torch.equal(v, net.state_dict()[k]), k
    assert set(pose.body_pose_state_dict(carried)) == set(sd)


def test_assembly_matches_jax(nets):
    """_find_peaks, _match_limbs and _assemble on the same maps."""
    _, _, net = nets
    heat, paf = pose.pose_maps(net, _photo(160, 112, 7))
    ours, ref = pose._find_peaks(heat), jax_pose._find_peaks(heat)
    assert ours == ref and sum(map(len, ours)) > 20
    conn, special = pose._match_limbs(paf, ours, heat.shape[0])
    rconn, rspecial = jax_pose._match_limbs(paf, ref, heat.shape[0])
    assert special == rspecial
    for a, b in zip(conn, rconn):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cand, subset = pose._assemble(ours, conn, special)
    rcand, rsubset = jax_pose._assemble(ref, rconn, rspecial)
    np.testing.assert_array_equal(cand, rcand)
    np.testing.assert_array_equal(subset, rsubset)
    assert len(subset) > 0


def test_drawing_matches_cv2():
    """ellipse2poly, fill_convex_poly and fill_circle against cv2 over
    seeded centres, axes and angles, partly outside the canvas too; then
    draw_bodypose against JAX's (cv2's) on the same people."""
    rng = np.random.default_rng(1)
    for _ in range(400):
        c = (int(rng.integers(-10, 110)), int(rng.integers(-10, 90)))
        axes = (int(rng.integers(0, 60)), int(rng.integers(0, 8)))
        angle = int(rng.integers(-400, 400))
        ref = cv2.ellipse2Poly(c, axes, angle, 0, 360, 1)
        poly = cv.ellipse2poly(c, axes, angle, 0, 360, 1)
        np.testing.assert_array_equal(poly, ref)
        color = [int(x) for x in rng.integers(0, 256, 3)]
        a, b = np.zeros((80, 100, 3), np.uint8), np.zeros((80, 100, 3), np.uint8)
        cv2.fillConvexPoly(a, ref, color)
        cv.fill_convex_poly(b, poly, color)
        np.testing.assert_array_equal(b, a)
        r = int(rng.integers(0, 9))
        cv2.circle(a, c, r, color, thickness=-1)
        cv.fill_circle(b, c, r, color)
        np.testing.assert_array_equal(b, a)
    cand = np.concatenate([rng.uniform(0, [96, 128], (30, 2)), rng.random((30, 1)),
                           np.arange(30)[:, None]], axis=1)
    subset = -np.ones((3, 20))
    for p in range(3):
        joints = rng.choice(18, 14, replace=False)
        subset[p, joints] = rng.choice(30, 14, replace=False)
    np.testing.assert_array_equal(pose.draw_bodypose(128, 96, cand, subset),
                                  jax_pose.draw_bodypose(128, 96, cand, subset))


@pytest.mark.parametrize("shape", [(512, 512, 3), (100, 77, 3), (37, 50, 1)])
def test_cubic_u8_resize_by_matches_cv2(shape, no_ipp):
    img = np.random.default_rng(shape[1]).integers(0, 256, shape, dtype=np.uint8)
    img = img[..., 0] if shape[2] == 1 else img
    for f in (0.359375, 0.7187, 1.3, 368 / 512):
        ref = cv2.resize(img, (0, 0), fx=f, fy=f, interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(cv.resize_by(img, f, f, "cubic"), ref)
        cv2.ipp.setUseIPP(True)
        ipp = cv2.resize(img, (0, 0), fx=f, fy=f, interpolation=cv2.INTER_CUBIC)
        cv2.ipp.setUseIPP(False)
        assert np.abs(ipp.astype(int) - ref.astype(int)).max() <= 1
    m = np.random.default_rng(2).standard_normal((7, 9, 19)).astype(np.float32)
    np.testing.assert_array_equal(cv.resize_by(m, 8, 8, "cubic"),
                                  cv2.resize(m, (0, 0), fx=8, fy=8,
                                             interpolation=cv2.INTER_CUBIC))


@pytest.fixture
def pose_dir(tmp_path, monkeypatch, nets):
    d = tmp_path / "Annotators"
    d.mkdir()
    torch.save(nets[0], d / "body_pose_model.pth")
    monkeypatch.setattr(jax_ann, "_model_dirs", [str(d)])
    monkeypatch.setattr(jax_ann, "_loaded", {})
    prev = list(annotators._model_dirs)
    annotators.set_annotator_dirs([str(d)])
    yield d
    annotators.set_annotator_dirs(prev)


@pytest.mark.parametrize("res", [0, 96])
def test_openpose_hint_matches_jax(pose_dir, no_ipp, res):
    """run_annotator("openpose") against JAX's: every pixel with cv2's own
    resize code (its IPP float resize moves JAX's peaks, ROADMAP C)."""
    img = _photo(128, 96, 11)
    ref = jax_ann.run_annotator("openpose", img, res=res)
    out = annotators.run_annotator("openpose", img, res=res, device="cpu")
    assert out.shape == ref.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    assert (out > 0).any(axis=-1).mean() > 0.05
