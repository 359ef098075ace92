"""The port's annotators against the JAX package's and OpenCV (CPU).

The numpy restatements of ``utils/cv`` against cv2 over grids of sizes,
sigmas and scales (up and down, integer and not): equal in every pixel,
except where a cv2 built with Intel IPP takes IPP's code for a float32 resize
(INTER_CUBIC and INTER_LINEAR), which the restatement cannot follow: there
it equals cv2 with IPP switched off, and against the default cv2 the test
states the largest difference; the float32 blur at ksize 7 states its own
(the last column only).  Then the tiny HED net against JAX's ``apply`` and
``estimate`` (1e-4 of the largest magnitude), and every registry module
the slice adds end to end against ``sdwebui_tpu.pipeline.annotators``,
with the model files written to a temporary directory and found by both
packages' lookup."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import itertools

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import hed as jax_hed
from sdwebui_tpu.pipeline import annotators as jax_ann
from sdwebui_tpu_torch.loader import convert
from sdwebui_tpu_torch.models import hed
from sdwebui_tpu_torch.pipeline import annotators
from sdwebui_tpu_torch.utils import cv
from test_torch_midas import random_dpt_state_dict
from test_torch_models import _assert_rel

from sdwebui_tpu_torch.pipeline.sd_model import TINY_DPT


@pytest.fixture
def no_ipp():
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _equal(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


# --------------------------------------------------------------------------
# the cv2 restatements
# --------------------------------------------------------------------------

SHAPES = [(37, 53, 3), (64, 80, 3), (33, 17, 1), (96, 128, 3)]


def _blur_grid(sigmas, per_sigma):
    """(shape, sigma) pairs whose kernel radius stays inside the image (the
    reflect-101 border of a narrower image is not restated)."""
    return [(shape, sigma) for shape, sigma in itertools.product(SHAPES, sigmas)
            if int(round(sigma * per_sigma + 1)) // 2 < min(shape[:2])]


@pytest.mark.parametrize("shape,sigma", _blur_grid([0.5, 0.75, 1.0, 3.0, 9.0], 6))
def test_gaussian_blur_u8_equals_cv2(shape, sigma):
    """The fixed-point path (ksize round(6σ+1)|1: 5, 5, 7, 19, 55)."""
    x = _u8(shape, 1)[..., 0] if shape[2] == 1 else _u8(shape, 1)
    _equal(cv.gaussian_blur(x, sigma), cv2.GaussianBlur(x, (0, 0), sigma))


@pytest.mark.parametrize("shape,sigma", _blur_grid([0.3, 0.5, 1.0, 3.0, 5.0], 8))
def test_gaussian_blur_f32_equals_cv2(shape, sigma):
    """ksize round(8σ+1)|1: 3, 5, 9, 25, 41 (the annotators' 0.5, 3 and 5
    among them)."""
    x = (np.random.default_rng(2).random(shape) * 255).astype(np.float32)
    x = x[..., 0] if shape[2] == 1 else x
    _equal(cv.gaussian_blur(x, sigma), cv2.GaussianBlur(x, (0, 0), sigma))


def test_gaussian_blur_f32_ksize7_bound():
    """ksize 7 (σ 0.7–0.8, on no annotator's path): the image's last column
    differs from cv2 in a few pixels by one float32 rounding; stated
    bound: max|Δ| <= 2 ulp of 255 and <= 1% of the pixels."""
    worst, share = 0.0, 0.0
    for shape, sigma in itertools.product([(37, 53, 3), (64, 29, 1)], [0.7, 0.75, 0.8]):
        x = (np.random.default_rng(3).random(shape) * 255).astype(np.float32)[..., :shape[2]]
        x = x[..., 0] if shape[2] == 1 else x
        d = np.abs(cv.gaussian_blur(x, sigma) - cv2.GaussianBlur(x, (0, 0), sigma))
        worst, share = max(worst, float(d.max())), max(share, float((d > 0).mean()))
        if d.max() > 0:
            assert set(np.nonzero(d)[1].tolist()) == {x.shape[1] - 1}
    assert worst <= 2 * np.spacing(np.float32(255)) and share <= 0.01


def test_dilate_equals_cv2():
    x = (np.random.default_rng(4).random((40, 50)) * 255).astype(np.float32)
    for k in hed._NMS_KERNELS:
        _equal(cv.dilate(x, k), cv2.dilate(x, kernel=k))
    u = _u8((23, 31), 5)
    _equal(cv.dilate(u, np.ones((3, 3), np.uint8)), cv2.dilate(u, np.ones((3, 3), np.uint8)))


RESIZE_DOWN = [((512, 512), (384, 384)), ((512, 512), (256, 256)), ((480, 640), (240, 320)),
               ((97, 131), (33, 47)), ((96, 96), (32, 32)), ((100, 150), (64, 96))]
RESIZE_UP = [((384, 384), (512, 512)), ((64, 64), (128, 128)), ((97, 131), (200, 300)),
             ((16, 20), (17, 21)), ((48, 48), (384, 384))]


@pytest.mark.parametrize("src,dst", RESIZE_DOWN)
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_area_equals_cv2(src, dst, channels):
    """INTER_AREA shrinking: the 2x2 and other integer fast paths, the
    float area weights otherwise."""
    x = _u8(src + (channels,), 6)
    x = x[..., 0] if channels == 1 else x
    _equal(cv.resize(x, dst[::-1], "area"),
           cv2.resize(x, dst[::-1], interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("src,dst", RESIZE_UP)
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_lanczos4_equals_cv2(src, dst, channels):
    x = _u8(src + (channels,), 7)
    x = x[..., 0] if channels == 1 else x
    _equal(cv.resize(x, dst[::-1], "lanczos4"),
           cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LANCZOS4))


def _float_cases():
    return RESIZE_UP + RESIZE_DOWN + [((65, 65), (512, 512)), ((49, 65), (384, 512))]


@pytest.mark.parametrize("mode,flag", [("cubic", cv2.INTER_CUBIC), ("linear", cv2.INTER_LINEAR)])
def test_resize_float_equals_cv2_without_ipp(no_ipp, mode, flag):
    for src, dst in _float_cases():
        x = np.random.default_rng(8).uniform(-1, 1, src).astype(np.float32) * 10
        _equal(cv.resize(x, dst[::-1], mode), cv2.resize(x, dst[::-1], interpolation=flag))


@pytest.mark.parametrize("mode,flag", [("cubic", cv2.INTER_CUBIC), ("linear", cv2.INTER_LINEAR)])
def test_resize_float_ipp_bound(mode, flag):
    """Against the default cv2 (IPP's float32 resize): max|Δ| within 5e-5
    of the largest magnitude (measured: cubic 2.7e-5, linear 3.3e-5, both
    at the 512 → 384 shrink; 1e-7–3e-6 at the scales depth_midas and
    shuffle use)."""
    for src, dst in _float_cases():
        x = np.random.default_rng(8).uniform(-1, 1, src).astype(np.float32) * 10
        _assert_rel(cv.resize(x, dst[::-1], mode), cv2.resize(x, dst[::-1], interpolation=flag),
                    5e-5)


@pytest.mark.parametrize("shape,spread", [((512, 512, 3), 256), ((64, 80, 3), 40),
                                          ((30, 40, 1), 10), ((384, 384, 3), 60)])
def test_remap_linear_equals_cv2(shape, spread):
    """Float maps, as shuffle's: coordinates inside the image (clipped)
    and past its border."""
    rng = np.random.default_rng(9)
    x = _u8(shape, 10)
    x = x[..., 0] if shape[2] == 1 else x
    h, w = shape[:2]
    for clip in (True, False):
        mx = np.arange(w)[None, :] + rng.uniform(-spread, spread, (h, w))
        my = np.arange(h)[:, None] + rng.uniform(-spread, spread, (h, w))
        if clip:
            mx, my = np.clip(mx, 0, w - 1), np.clip(my, 0, h - 1)
        mx, my = mx.astype(np.float32), my.astype(np.float32)
        _equal(cv.remap_linear(x, mx, my), cv2.remap(x, mx, my, cv2.INTER_LINEAR))


# --------------------------------------------------------------------------
# HED
# --------------------------------------------------------------------------

TINY_HED = (8, 12, 16, 16, 16)


def _hed_state_dict(seed=0, widths=TINY_HED):
    """ControlNetHED keys under ``netNetwork.``, N(0, 1/fan_in) weights,
    N(0, 0.1²) biases, an input shift of N(0, 1)·60."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in hed.ControlNetHED(widths, device="meta").state_dict().items():
        shape = tuple(t.shape)
        if name == "norm":
            a = rng.standard_normal(shape) * 60
        elif len(shape) == 4:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.1 * rng.standard_normal(shape)
        out["netNetwork." + name] = torch.from_numpy(a.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def hed_nets():
    sd = _hed_state_dict()
    params = jax_hed.convert_hed({k: v.numpy() for k, v in sd.items()})
    flat, widths = convert.convert_hed(sd)
    net = hed.ControlNetHED(widths)
    net.load_state_dict(flat, strict=True)
    return params, net


def test_hed_net_matches_jax(hed_nets):
    params, net = hed_nets
    x = np.random.default_rng(11).random((1, 40, 56, 3)).astype(np.float32) * 255
    ref = jax_hed.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(out) == 5
    for o, r in zip(out, ref):
        _assert_rel(o.permute(0, 2, 3, 1).numpy(), np.asarray(r), 1e-4)
    img = _u8((40, 56, 3), 12)
    _assert_rel(hed.estimate(net, img), jax_hed.estimate(params, img), 1e-4)


def test_hed_posts_equal_jax():
    edge = np.random.default_rng(13).random((37, 45)).astype(np.float32)
    _equal(hed.safe_step(edge), jax_hed.safe_step(edge))
    u8 = (edge * 255).astype(np.uint8)
    _equal(hed.nms(u8, 127, 3.0), jax_hed.nms(u8, 127, 3.0))


def test_convert_hed_widths():
    flat, widths = convert.convert_hed(_hed_state_dict())
    assert widths == TINY_HED and flat["norm"].shape == (1, 3, 1, 1)
    bare = {k.removeprefix("netNetwork."): v for k, v in _hed_state_dict().items()}
    assert convert.convert_hed(bare)[1] == TINY_HED
    assert hed.ControlNetHED(device="meta").widths == (64, 128, 256, 512, 512)


# --------------------------------------------------------------------------
# the registry against the JAX package's
# --------------------------------------------------------------------------

@pytest.fixture
def annotator_dir(tmp_path, monkeypatch):
    """Tiny HED and DPT files found by both packages' lookup."""
    d = tmp_path / "Annotators"
    d.mkdir()
    torch.save(_hed_state_dict(1), d / "ControlNetHED.pth")
    torch.save({k: torch.from_numpy(v) for k, v in random_dpt_state_dict(TINY_DPT, 2).items()},
               d / "dpt_hybrid-midas-501f0c75.pt")
    monkeypatch.setattr(jax_ann, "_model_dirs", [str(d)])
    monkeypatch.setattr(jax_ann, "_loaded", {})
    prev = list(annotators._model_dirs)
    annotators.set_annotator_dirs([str(d)])
    yield d
    annotators.set_annotator_dirs(prev)


def _photo(h=64, w=64, seed=14):
    """Blocky colours plus noise: edges for HED, structure for MiDaS."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8, 3)), np.ones((8, 8, 1)))
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


# (module, thresholds, bound): 0 = equal in every pixel; otherwise the
# largest uint8 difference and the share of pixels allowed to differ (the
# nets' float rounding against XLA's ahead of a truncation to uint8; the
# IPP float resize in JAX's shuffle and depth_midas).  Measured: shuffle 1
# level in 0.011% of the pixels, depth 1 level in 0.024%, HED equal.
REGISTRY = [("blur_gaussian", (3.0,), 0), ("blur_gaussian", (), 0),
            ("scribble_xdog", (32,), 0), ("scribble_xdog", (8,), 0),
            ("shuffle", (), (1, 0.002)),
            ("hed", (), (1, 0.002)), ("softedge_hed", (), (1, 0.002)),
            ("hed_safe", (), (1, 0.002)), ("scribble_hed", (), (255, 0.002)),
            ("depth", (), (1, 0.002)), ("depth_midas", (), (1, 0.002))]


@pytest.mark.parametrize("module,thresholds,bound", REGISTRY)
@pytest.mark.parametrize("res", [0, 48, 96])
def test_registry_module_matches_jax(annotator_dir, module, thresholds, bound, res):
    """Each module at res 0 (as a unit runs it), shrinking (INTER_AREA) and
    growing (INTER_LANCZOS4) a 64x64 image."""
    img = _photo()
    args = dict(zip(("threshold_a", "threshold_b"), thresholds))
    ref = jax_ann.run_annotator(module, img, res=res, **args)
    out = annotators.run_annotator(module, img, res=res, device="cpu", **args)
    assert out.dtype == ref.dtype == np.uint8 and out.shape == ref.shape
    if bound == 0:
        _equal(out, ref)
    else:
        d = np.abs(out.astype(int) - ref.astype(int))
        assert d.max() <= bound[0] and (d > 0).mean() <= bound[1], (d.max(), (d > 0).mean())
    if module not in ("blur_gaussian", "shuffle"):
        assert len(np.unique(out)) > 1


def test_weight_lookup_and_cache(annotator_dir, tmp_path):
    assert annotators._find_weights("controlnethed", "hed").endswith("ControlNetHED.pth")
    assert annotators._find_weights("dpt_hybrid", "midas").endswith(".pt")
    assert annotators._find_weights("body_pose") is None
    img = _photo()
    annotators.run_annotator("hed", img, res=0, device="cpu")
    assert ("hed", "cpu") in annotators._loaded
    annotators.set_annotator_dirs([str(tmp_path / "empty")])
    assert not annotators._loaded
    with pytest.raises(RuntimeError, match="depth_midas"):
        annotators.run_annotator("depth_midas", img, res=0, device="cpu")


def test_model_annotators_default_to_the_card(annotator_dir):
    """No device given: the card, and no card here raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        annotators.run_annotator("hed", _photo(), res=0)


def test_openpose_needs_its_weights():
    """openpose is ported (tests/test_torch_openpose.py); without a
    body_pose file it raises naming the file, as JAX's lookup does."""
    with pytest.raises(RuntimeError, match="body_pose"):
        annotators.run_annotator("openpose", _photo(), res=0, device="cpu")
    assert annotators.list_modules() == jax_ann.list_modules()
