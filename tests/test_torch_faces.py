"""Face restoration in the port against the JAX package (CPU, f32).

RetinaFace (width 0.25), GFPGAN and CodeFormer at the tiny configs of
``tests/test_gfpgan.py`` / ``test_codeformer.py`` run on one JAX tree
carried across with ``*_from_jax`` (the JAX trees made by the JAX package's
own converters from seeded state dicts), within the JAX tests' bounds:
RetinaFace rtol 1e-3 / atol 2e-4, GFPGAN 5e-4 and CodeFormer 2e-4 of the
largest magnitude, CodeFormer's code logits too and its indices equal.
The Pillow restatements of ``faces.py`` (the affine bilinear warp and
MinFilter) equal Pillow in every pixel; ``faces.restore_faces`` equals
JAX's in every pixel, full-frame and with a detector, around a stand-in
restorer both compute exactly, and within 1 level around the nets; tiny
txt2img and
img2img with ``restore_faces`` and the Extras face stages are held to JAX;
missing weights log once and leave the images as JAX leaves them.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import dataclasses
import logging
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from sdwebui_tpu.models import codeformer as jax_cf
from sdwebui_tpu.models import gfpgan as jax_gfpgan
from sdwebui_tpu.models import retinaface as jax_rf
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.postprocessing import faces as jax_faces
from sdwebui_tpu.postprocessing import stages as jax_stages
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu_torch.loader.load import read_checkpoint as port_read_checkpoint
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.models import codeformer as port_cf
from sdwebui_tpu_torch.models import gfpgan as port_gfpgan
from sdwebui_tpu_torch.models import retinaface as port_rf
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.postprocessing import faces as port_faces
from sdwebui_tpu_torch.postprocessing import stages as port_stages
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.utils import images as port_images
from test_torch_img2img import f32_policies, models  # noqa: F401
from test_torch_inpaint import _smooth_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GFPGAN_CFG = dict(out_size=32, num_style_feat=16, channel_multiplier=1)
CODEFORMER_CFG = dict(img_size=32, nf=8, ch_mult=(1, 2, 4), res_blocks=2, attn_resolutions=(8,),
                      emb_dim=16, codebook_size=32, dim_embd=32, n_head=4, n_layers=2,
                      connect_list=("16",))


def _np_sd(net: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def _retinaface_sd(seed: int = 0, face_bias: float = 0.0) -> dict:
    """A seeded width-0.25 RetinaFace state dict in facexlib's layout with
    random BatchNorm statistics; face_bias pushes the class heads toward
    "face" so that random weights detect."""
    net = port_rf.create_random_retinaface(seed, "cpu", 0.25)
    g = torch.Generator().manual_seed(seed + 1)
    sd = _np_sd(net)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = (torch.randn(sd[k].shape, generator=g) * 0.3).numpy()
        elif k.endswith("running_var"):
            sd[k] = (torch.rand(sd[k].shape, generator=g) + 0.5).numpy()
        elif k.startswith("ClassHead.") and k.endswith("bias"):
            sd[k] = np.tile(np.float32([0.0, face_bias]), sd[k].shape[0] // 2)
    return sd


def _gfpgan_sd(seed: int = 3) -> dict:
    """A seeded tiny GFPGANv1-clean state dict in the checkpoint's layout."""
    cfg = port_gfpgan.GFPGANConfig(**GFPGAN_CFG)
    return _np_sd(port_gfpgan.create_random_gfpgan(seed, "cpu", cfg))


def _codeformer_sd(seed: int = 4) -> dict:
    cfg = port_cf.CodeFormerConfig(**CODEFORMER_CFG)
    return _np_sd(port_cf.create_random_codeformer(seed, "cpu", cfg))


def _image(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3)).astype(np.uint8)
    return np.kron(base, np.ones((4, 4, 1), np.uint8))[:h, :w].copy()


def _rel(out, ref) -> float:
    return float(np.abs(np.asarray(out) - np.asarray(ref)).max()
                 / max(np.abs(np.asarray(ref)).max(), 1.0))


# --------------------------------------------------------------------------
# the nets on one JAX tree
# --------------------------------------------------------------------------

def test_retinaface_matches_jax():
    tree = jax_rf.convert_retinaface(_retinaface_sd(0))
    net = port_rf.retinaface_from_jax(tree)
    x = np.random.default_rng(0).random((1, 64, 72, 3), dtype=np.float32) * 255
    ref = jax_rf.apply(tree, jnp.asarray(x))
    with torch.inference_mode():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    n = sum(int(np.ceil(64 / s)) * int(np.ceil(72 / s)) * 2 for s in port_rf.STEPS)
    for r, g in zip(ref, got):
        assert g.shape[0] == n
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=2e-4)
    np.testing.assert_array_equal(port_rf.priors(64, 72), jax_rf.priors(64, 72))


def test_retinaface_checkpoint_layout_and_detect_faces(tmp_path):
    """facexlib's file (``module.`` prefix, num_batches_tracked) in both
    packages' loaders, and detect_faces with a head biased to "face"."""
    sd = _retinaface_sd(2, face_bias=4.0)
    path = str(tmp_path / "detection_Resnet50_Final.safetensors")
    write_safetensors(path, {"module." + k: torch.from_numpy(v) for k, v in sd.items()}
                      | {"module.body.bn1.num_batches_tracked": torch.tensor(0)})
    jax_tree = jax_rf.convert_retinaface(sd)
    net = port_rf.load_retinaface(path, "cpu")
    img = _image(1, 64, 64)
    ref = jax_rf.detect_faces(jax_tree, Image.fromarray(img))
    out = port_rf.detect_faces(net, img)
    assert len(out) == len(ref) >= 1
    for (lm, score, box), (jlm, jscore, jbox) in zip(out, ref):
        np.testing.assert_allclose(lm, jlm, rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(box, jbox, rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(score, jscore, rtol=1e-3, atol=2e-4)
    # an image in [0, 1] is read as [0, 255] (retinaface.py:193), as in JAX
    assert len(port_rf.detect_faces(net, img / 255.0)) == len(out)


@pytest.mark.parametrize("case", ["decode", "nms"])
def test_retinaface_decode_and_nms_match_jax(case):
    rng = np.random.default_rng(5)
    pri = port_rf.priors(40, 56)
    if case == "decode":
        loc = rng.standard_normal((len(pri), 4)).astype(np.float32)
        landm = rng.standard_normal((len(pri), 10)).astype(np.float32)
        np.testing.assert_array_equal(port_rf.decode_boxes(loc, pri),
                                      jax_rf.decode_boxes(loc, pri))
        np.testing.assert_array_equal(port_rf.decode_landms(landm, pri),
                                      jax_rf.decode_landms(landm, pri))
    else:
        xy = rng.random((60, 2)) * 50
        boxes = np.concatenate([xy, xy + rng.random((60, 2)) * 20 + 1], axis=1)
        scores = rng.random(60).astype(np.float32)
        assert port_rf.nms(boxes, scores, 0.4) == jax_rf.nms(boxes, scores, 0.4)


def test_gfpgan_matches_jax():
    sd = _gfpgan_sd()
    for k in sd:       # non-zero noise strengths: the noise path runs
        if k.startswith("stylegan_decoder.style_conv") and k.endswith(".weight") \
                and sd[k].size == 1:
            sd[k] = np.full_like(sd[k], 0.3)
    tree, cfg = jax_gfpgan.convert_gfpgan({"params_ema." + k: v for k, v in sd.items()})
    net = port_gfpgan.gfpgan_from_jax(tree)
    # both read channel multiplier 2 (at 32² it gives multiplier 1's widths)
    assert dataclasses.asdict(net.cfg) == dataclasses.asdict(cfg)
    x = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32) * 2 - 1
    ref = np.asarray(jax_gfpgan.apply(tree, cfg, jnp.asarray(x)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1)
    assert _rel(got.numpy(), ref) < 5e-4
    assert np.abs(ref).max() > 0.1


def _jax_codeformer_logits(tree, cfg, x):
    """JAX's apply up to the code logits (codeformer.py:366-383)."""
    e_plan, e_fuse = jax_cf.encoder_plan(cfg)
    lq = jax_cf._walk_blocks(tree["encoder"], e_plan, jnp.asarray(x))
    b, hh, ww, c = lq.shape
    q = lq.reshape(b, hh * ww, c) @ tree["feat_emb"]["weight"].T + tree["feat_emb"]["bias"]
    pos = jnp.asarray(tree["position_emb"])[None]
    for li in range(cfg.n_layers):
        q = jax_cf._ft_layer(tree["ft_layers"][str(li)], q, pos, cfg.n_head)
    return np.asarray(jax_cf._ln(tree["idx_pred_layer"]["0"], q)
                      @ tree["idx_pred_layer"]["1"]["weight"].T)


@pytest.mark.parametrize("w,adain", [(0.6, True), (0.6, False), (0.0, True), (0.0, False)])
def test_codeformer_matches_jax(w, adain):
    sd = _codeformer_sd()
    tree, _ = jax_cf.convert_codeformer({"params_ema." + k: v for k, v in sd.items()})
    cfg = jax_cf.CodeFormerConfig(**CODEFORMER_CFG)
    net = port_cf.codeformer_from_jax(tree, port_cf.CodeFormerConfig(**CODEFORMER_CFG))
    x = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32) * 2 - 1
    ref = np.asarray(jax_cf.apply(tree, cfg, jnp.asarray(x), w=w, adain=adain))
    with torch.inference_mode():
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        lq, feats, logits = net.encode(xt)
        got = net.decode(lq, feats, logits, w=w, adain=adain).permute(0, 2, 3, 1).numpy()
    ref_logits = _jax_codeformer_logits(tree, cfg, x)
    assert _rel(logits.numpy(), ref_logits) < 2e-4
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), ref_logits.argmax(-1))
    assert _rel(got, ref) < 2e-4
    assert np.abs(ref).max() > 0.1


def test_codeformer_plans_and_file_config():
    """The flat block plans equal JAX's, at the published config (the
    official fuse tables) and the tiny one; a file's config is read as
    convert_codeformer reads it."""
    for kw in ({}, CODEFORMER_CFG):
        jcfg, pcfg = jax_cf.CodeFormerConfig(**kw), port_cf.CodeFormerConfig(**kw)
        assert port_cf.encoder_plan(pcfg) == jax_cf.encoder_plan(jcfg)
        assert port_cf.generator_plan(pcfg) == jax_cf.generator_plan(jcfg)
    _, ef = port_cf.encoder_plan(port_cf.CodeFormerConfig())
    assert ef == {512: 2, 256: 5, 128: 8, 64: 11, 32: 14, 16: 18}
    sd = _codeformer_sd()
    _, jcfg = jax_cf.convert_codeformer(sd)
    assert dataclasses.asdict(port_cf.config_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()})) == dataclasses.asdict(jcfg)
    full = {k: torch.empty(v.shape, device="meta")
            for k, v in port_cf.CodeFormer(device="meta").state_dict().items()}
    assert port_cf.config_from_state_dict(full) == port_cf.CodeFormerConfig()


def test_gfpgan_file_layout_and_published_config(tmp_path):
    """A ``params_ema`` file with the checkpoint's shapes (biases (1, C, 1,
    1), noise strength (1,), a style_mlp to drop) loads in both packages to
    the same net; the published v1.4 layout reads back as its config."""
    sd = _gfpgan_sd(5)
    sd["stylegan_decoder.style_mlp.1.weight"] = np.zeros((16, 16), np.float32)
    path = str(tmp_path / "GFPGANv1.4.safetensors")
    write_safetensors(path, {"params_ema." + k: torch.from_numpy(v) for k, v in sd.items()})
    from sdwebui_tpu.loader.load import read_checkpoint

    tree, cfg = jax_gfpgan.convert_gfpgan(read_checkpoint(path))
    net = port_gfpgan.gfpgan_from_state_dict(port_read_checkpoint(path), "cpu")
    x = np.random.default_rng(2).random((1, 32, 32, 3), dtype=np.float32) * 2 - 1
    with torch.inference_mode():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1)
    assert _rel(got.numpy(), np.asarray(jax_gfpgan.apply(tree, cfg, jnp.asarray(x)))) < 5e-4
    full = {k: torch.empty(v.shape, device="meta")
            for k, v in port_gfpgan.GFPGAN(device="meta").state_dict().items()}
    assert port_gfpgan.config_from_state_dict(full) == port_gfpgan.GFPGANConfig()


# --------------------------------------------------------------------------
# the Pillow restatements
# --------------------------------------------------------------------------

AFFINE_CASES = {
    "identity_rgb": ((1, 0, 0, 0, 1, 0), (37, 29), (37, 29), 3),
    "shift_l": ((1, 0, 3.25, 0, 1, -2.5), (30, 41), (33, 40), 1),
    "rotate_rgb": ("rot", (45, 61), (52, 38), 3),
    "rotate_scale_l": ("rot_scale", (64, 48), (31, 70), 1),
    "shrink_rgb": ((2.3, 0.1, -4.0, -0.2, 1.7, 6.0), (97, 83), (40, 44), 3),
    "face_crop": ("face", (64, 64), (32, 32), 3),
}


@pytest.mark.parametrize("case", list(AFFINE_CASES))
def test_affine_transform_equals_pillow(case):
    coeffs, (ih, iw), size, c = AFFINE_CASES[case]
    if coeffs == "rot":
        t = 0.41
        coeffs = (np.cos(t), -np.sin(t), 20.0, np.sin(t), np.cos(t), -7.5)
    elif coeffs == "rot_scale":
        t, s = -2.2, 0.63
        coeffs = (s * np.cos(t), -s * np.sin(t), 40.0, s * np.sin(t), s * np.cos(t), 35.0)
    elif coeffs == "face":
        lm = jax_faces.FACE_TEMPLATE_512 / 512.0 * 24.0 + 4.0 + [[0.3, -0.8]] * 5
        inv = jax_faces._invert_affine(jax_faces.similarity_transform(
            lm, jax_faces.FACE_TEMPLATE_512 * (32 / 512.0)))
        coeffs = tuple(inv.reshape(-1))
    img = np.random.default_rng(7).integers(0, 256, (ih, iw, c), dtype=np.uint8)
    img = img[:, :, 0] if c == 1 else img
    ref = Image.fromarray(img).transform(size, Image.AFFINE, tuple(float(v) for v in coeffs),
                                         resample=Image.BILINEAR)
    np.testing.assert_array_equal(port_images.affine_transform(img, size, coeffs),
                                  np.asarray(ref))


@pytest.mark.parametrize("size", [3, 9])
def test_min_filter_equals_pillow(size):
    rng = np.random.default_rng(size)
    for shape in ((23, 31), (64, 64)):
        m = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = Image.fromarray(m).filter(ImageFilter.MinFilter(size))
        np.testing.assert_array_equal(port_images.min_filter(m, size), np.asarray(ref))


def test_geometry_matches_jax():
    rng = np.random.default_rng(8)
    src = rng.random((5, 2)) * 100
    dst = rng.random((5, 2)) * 300
    m = port_faces.similarity_transform(src, dst)
    np.testing.assert_array_equal(m, jax_faces.similarity_transform(src, dst))
    np.testing.assert_array_equal(port_faces.invert_affine(m), jax_faces._invert_affine(m))
    img = _image(9, 48, 40)
    np.testing.assert_array_equal(port_faces.warp(img, m * 0.3, (33, 35)), np.asarray(
        jax_faces._warp(Image.fromarray(img), m * 0.3, (33, 35))))


# --------------------------------------------------------------------------
# faces.restore_faces against JAX's
# --------------------------------------------------------------------------

@pytest.fixture
def gfpgan_dir(tmp_path):
    d = tmp_path / "GFPGAN"
    d.mkdir()
    write_safetensors(str(d / "GFPGANv1.4.safetensors"),
                      {"params_ema." + k: torch.from_numpy(v) for k, v in _gfpgan_sd().items()})
    for faces in (jax_faces, port_faces):
        faces.set_model_dirs("GFPGAN", [str(d)])
    yield str(d)
    for faces in (jax_faces, port_faces):
        faces.set_model_dirs("GFPGAN", ["models/GFPGAN"])
        faces.set_face_detector(None)


@pytest.fixture
def codeformer_pair():
    """The tiny CodeFormer resident in both packages' model caches (a file
    would be read at the published 512², as convert_codeformer reads it)."""
    sd = _codeformer_sd()
    tree, _ = jax_cf.convert_codeformer(sd)
    jcfg = jax_cf.CodeFormerConfig(**CODEFORMER_CFG)
    net = port_cf.codeformer_from_jax(tree, port_cf.CodeFormerConfig(**CODEFORMER_CFG))
    jax_faces._models.clear()
    jax_faces._models["CodeFormer"] = (
        lambda x, w: jax_cf.apply(tree, jcfg, x, w=w, adain=True), 32)
    port_faces._models.clear()
    port_faces._models[("CodeFormer", "cpu")] = (net, 32)
    yield
    jax_faces._models.clear()
    port_faces._models.clear()


def _fixed_face(h: int, w: int):
    """One face in the upper-left quadrant (tests/test_faces.py:75)."""
    return jax_faces.FACE_TEMPLATE_512 / 512.0 * (min(h, w) * 0.4) + 4.0


class _Mirror(torch.nn.Module):
    """A stand-in restorer both packages compute exactly: the crop negated
    and mirrored, so that the geometry is what is compared."""

    def forward(self, x, w=0.5, adain=True):
        return -x.flip(3)


@pytest.fixture
def mirror_restorer():
    jax_faces._models.clear()
    jax_faces._models["GFPGAN"] = (lambda x, w: -x[:, :, ::-1], 32)
    port_faces._models.clear()
    port_faces._models[("GFPGAN", "cpu")] = (_Mirror(), 32)
    yield
    jax_faces._models.clear()
    port_faces._models.clear()
    for faces in (jax_faces, port_faces):
        faces.set_face_detector(None)


@pytest.mark.parametrize("detector", [False, True])
def test_restore_faces_equals_jax(mirror_restorer, detector):
    """Every pixel equal, full-frame and with a fixed-landmark detector, at
    visibility 1 and 0.6; "None" and visibility 0 hand the input back."""
    img = _image(10, 56, 48)
    if detector:
        lm = _fixed_face(56, 48)
        jax_faces.set_face_detector(lambda im: [lm])
        port_faces.set_face_detector(lambda im: [lm])
    for vis in (1.0, 0.6):
        ref = jax_faces.restore_faces(Image.fromarray(img), "GFPGAN", visibility=vis)
        out = port_faces.restore_faces(img, "GFPGAN", visibility=vis, device="cpu")
        np.testing.assert_array_equal(out, np.asarray(ref))
    assert not np.array_equal(out, img)
    if detector:      # the far corner lies outside the pasted face's mask
        np.testing.assert_array_equal(out[48:, 40:], img[48:, 40:])
    assert port_faces.restore_faces(img, "None", device="cpu") is img
    assert port_faces.restore_faces(img, "GFPGAN", visibility=0.0, device="cpu") is img


def _close(out, ref):
    """Within 1 level, in under 1% of the pixels: the nets' f32 sums round
    differently in XLA and in torch."""
    d = np.abs(out.astype(int) - np.asarray(ref, int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("detector", [False, True])
@pytest.mark.parametrize("restorer", ["GFPGAN", "CodeFormer"])
def test_restore_faces_with_the_nets_matches_jax(gfpgan_dir, codeformer_pair, detector,
                                                 restorer):
    img = _image(10, 56, 48)
    if detector:
        lm = _fixed_face(56, 48)
        jax_faces.set_face_detector(lambda im: [lm])
        port_faces.set_face_detector(lambda im: [lm])
    ref = jax_faces.restore_faces(Image.fromarray(img), restorer, weight=0.5, visibility=0.8)
    out = port_faces.restore_faces(img, restorer, weight=0.5, visibility=0.8, device="cpu")
    _close(out, ref)
    assert not np.array_equal(out, img)


def test_retinaface_detector_restores_like_jax(gfpgan_dir, tmp_path):
    """install_detector in both packages on one file, then restore_faces."""
    path = str(tmp_path / "detection_Resnet50_Final.safetensors")
    write_safetensors(path, {k: torch.from_numpy(v)
                             for k, v in _retinaface_sd(2, face_bias=4.0).items()})
    jax_det = jax_rf.install_detector(path)
    port_det = port_rf.install_detector(path, "cpu")
    img = _image(1, 64, 64)
    found = port_det(img)
    assert len(found) == len(jax_det(Image.fromarray(img))) >= 1
    ref = np.asarray(jax_faces.restore_faces(Image.fromarray(img), "GFPGAN"))
    _close(port_faces.restore_faces(img, "GFPGAN", device="cpu"), ref)


def test_available_restorers_and_the_route(gfpgan_dir):
    assert port_faces.available_restorers() == jax_faces.available_restorers() \
        == ["None", "GFPGAN"]
    api = Api(Engine(device="cpu", tiny=True))
    assert api.handle("GET", "/sdapi/v1/face-restorers", None) == (
        200, [{"name": "None", "cmd_dir": None}, {"name": "GFPGAN", "cmd_dir": None}])


def test_one_face_model_resident(gfpgan_dir, codeformer_pair):
    port_faces.restore_faces(_image(3, 32, 32), "GFPGAN", device="cpu")
    assert list(port_faces._models) == [("GFPGAN", "cpu")]
    (net, size), = port_faces._models.values()
    assert size == 32 and all(p.dtype == torch.float32 for p in net.parameters())


# --------------------------------------------------------------------------
# the pipelines and the Extras stages
# --------------------------------------------------------------------------

FACE_SETTINGS = {"sdtpu_vae_bf16": False, "face_restoration_model": "GFPGAN"}


@pytest.mark.parametrize("route", ["txt2img", "img2img"])
def test_pipeline_restore_faces_matches_jax(models, f32_policies, gfpgan_dir, route):  # noqa: F811
    """A tiny request with restore_faces: GFPGAN after the decode (and, in
    img2img, before colour correction): pixels within 1 level of JAX's,
    identical infotext naming the restorer."""
    base = dict(prompt="a face", seed=21, steps=3, width=64, height=64, batch_size=2,
                restore_faces=True, override_settings=dict(FACE_SETTINGS))
    if route == "img2img":
        # a smooth init: colour correction maps a blocky one's 1-level
        # differences to the next of its few colours (test_torch_inpaint)
        base.update(init_images=[_smooth_image()], denoising_strength=0.6,
                    override_settings=dict(FACE_SETTINGS, img2img_color_correction=True))
        ref = jax_i2i.process_img2img(models[0], JaxParams(**base))
        out = port_i2i.process_img2img(models[1], GenerationParams(**base))
        plain = port_i2i.process_img2img(models[1], GenerationParams(
            **dict(base, restore_faces=False)))
    else:
        ref = jax_proc.process_txt2img(models[0], JaxParams(**base))
        out = port_proc.process_txt2img(models[1], GenerationParams(**base))
        plain = port_proc.process_txt2img(models[1], GenerationParams(
            **dict(base, restore_faces=False)))
    assert len(out.images) == len(ref.images)
    for a, b in zip(out.images, ref.images):
        assert np.abs(a.astype(int) - np.asarray(b, int)).max() <= 1
    assert out.infotexts == ref.infotexts and "Face restoration: GFPGAN" in out.infotexts[-1]
    assert not np.array_equal(out.images[-1], plain.images[-1])


def test_missing_weights_log_once_and_match_jax(models, f32_policies, caplog, tmp_path):  # noqa: F811
    """No CodeFormer file: the images stay as they are, the infotext still
    names the restorer (as JAX writes it), one warning per restorer."""
    for faces in (jax_faces, port_faces):
        faces.set_model_dirs("CodeFormer", [str(tmp_path / "none")])
    port_proc._FACE_SKIPS_LOGGED.discard("CodeFormer")
    base = dict(prompt="a face", seed=22, steps=2, width=64, height=64, restore_faces=True,
                override_settings={"sdtpu_vae_bf16": False})
    try:
        ref = jax_proc.process_txt2img(models[0], JaxParams(**base))
        with caplog.at_level(logging.WARNING, logger="sdwebui_tpu_torch.pipeline.processing"):
            out = port_proc.process_txt2img(models[1], GenerationParams(**base))
            again = port_proc.process_txt2img(models[1], GenerationParams(**base))
        plain = port_proc.process_txt2img(models[1], GenerationParams(
            **dict(base, restore_faces=False)))
    finally:
        for faces in (jax_faces, port_faces):
            faces.set_model_dirs("CodeFormer", ["models/Codeformer"])
    warnings = [r for r in caplog.records if r.name.startswith("sdwebui_tpu_torch")
                and "face restoration skipped" in r.getMessage()]
    assert len(warnings) == 1 and "CodeFormer" in warnings[0].getMessage()
    np.testing.assert_array_equal(out.images[0], plain.images[0])
    np.testing.assert_array_equal(again.images[0], out.images[0])
    assert np.abs(out.images[0].astype(int) - np.asarray(ref.images[0], int)).max() <= 1
    assert out.infotexts == ref.infotexts and "Face restoration: CodeFormer" in out.infotexts[0]


def test_save_images_before_face_restoration_raises(models, f32_policies,  # noqa: F811
                                                     mirror_restorer, tmp_path):
    """save_images_before_face_restoration, which the port once refused: the
    decoded image saved as "-before-face-restoration" before the restorer
    runs, then the restored sample, under JAX's names and infotexts, the
    pixels within 1 level of JAX's files."""
    from sdwebui_tpu.utils import images as jax_images
    from sdwebui_tpu_torch.utils import saving
    from sdwebui_tpu_torch.utils.png import decode_png

    base = dict(prompt="a face", seed=1, steps=2, width=64, height=64, restore_faces=True,
                override_settings=dict(FACE_SETTINGS, save_to_dirs=False,
                                       save_images_before_face_restoration=True))
    jax_proc.process_txt2img(models[0], JaxParams(**base), outdir=str(tmp_path / "jax"))
    out = port_proc.process_txt2img(models[1], GenerationParams(**base),
                                    outdir=str(tmp_path / "port"))
    jax_images.flush_saves()
    saving.flush_saves()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 2
    assert names[0].endswith("-before-face-restoration.png")
    saved = []
    for name in names:
        img, text = decode_png((tmp_path / "port" / name).read_bytes())
        with Image.open(tmp_path / "jax" / name) as ref:
            assert np.abs(img.astype(int) - np.asarray(ref, int)).max() <= 1
            assert text == {"parameters": ref.info["parameters"]} == \
                {"parameters": out.infotexts[0]}
        saved.append(img)
    np.testing.assert_array_equal(saved[1], out.images[0])
    assert not np.array_equal(saved[0], saved[1])


EXTRAS_CASES = {
    "gfpgan": dict(gfpgan_visibility=1.0),
    "codeformer_half": dict(codeformer_visibility=0.5, codeformer_weight=0.3),
    "gfpgan_upscaled": dict(upscaler_1="Lanczos", upscaling_resize=1.5, gfpgan_visibility=0.7),
}


@pytest.mark.parametrize("case", list(EXTRAS_CASES))
def test_extras_face_stages_match_jax(gfpgan_dir, codeformer_pair, case):
    img = _image(12, 40, 36)
    ref = jax_stages.run_stages(Image.fromarray(img),
                                jax_stages.StageArgs.from_obj(EXTRAS_CASES[case]))
    out = port_stages.run_stages(img, port_stages.StageArgs.from_obj(EXTRAS_CASES[case]),
                                 device="cpu")
    assert out.shape == np.asarray(ref).shape
    _close(out, ref)


_HYGIENE = r"""
import sys
BLOCKED = ("sdwebui_tpu", "jax", "jaxlib", "PIL", "pydantic", "ml_dtypes", "cv2")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Blocker())
import numpy as np, torch
from sdwebui_tpu_torch.models import retinaface
from sdwebui_tpu_torch.postprocessing import faces
d, det = sys.argv[1], sys.argv[2]
faces.set_model_dirs("GFPGAN", [d])
retinaface.install_detector(det, "cpu")
img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
out = faces.restore_faces(img, "GFPGAN", device="cpu")
assert out.shape == img.shape and not np.array_equal(out, img)
print("OK")
"""


def test_faces_run_without_jax_pil_cv2(gfpgan_dir, tmp_path):
    det = str(tmp_path / "det.safetensors")
    write_safetensors(det, {k: torch.from_numpy(v)
                            for k, v in _retinaface_sd(2, face_bias=4.0).items()})
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _HYGIENE, gfpgan_dir, det], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK"
