"""The dataset, the preprocessing pass and their restatements of Pillow and
cv2 in the port, against the JAX package and the libraries (CPU).

Bounds: the dataset's latents within 1e-5 of their largest magnitude, its
entries, captions and alpha weights equal (the tiny twin SD1 model of
``test_torch_img2img``, f32); ``utils/cv.good_features_to_track`` equal to
``cv2.goodFeaturesToTrack(maxCorners=50, qualityLevel=0.04,
minDistance=10)`` corner for corner, and ``corner_min_eigen_val`` and
``rgb_to_gray`` in every value; Pillow's Lanczos resize over a fractional
box in every pixel; ``split_oversized``, ``center_crop``,
``autosized_crop``, ``autocrop_image`` and ``preprocess_dir`` (files,
pixels and DeepDanbooru captions, at a reduced plan) equal to JAX's.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.models import deepbooru as jax_db
from sdwebui_tpu.training import dataset as jax_ds
from sdwebui_tpu.training import preprocess as jax_pre
from sdwebui_tpu_torch.models import deepbooru as port_db
from sdwebui_tpu_torch.training import dataset as port_ds
from sdwebui_tpu_torch.training import preprocess as port_pre
from sdwebui_tpu_torch.utils import cv as port_cv
from sdwebui_tpu_torch.utils import images as port_images
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import f32_policies, models  # noqa: F401
from test_torch_training import _rel, data_dir  # noqa: F401

TINY_PLAN = (("stage", 2, 4, 16, 1), ("stage", 2, 8, 32, 2), ("mid_down", 8, 32, 2),
             ("blocks", 1, 8, 32))


def _images(seed: int, count: int = 6):
    """Noise, blurred noise and blocky images of assorted sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        h, w = (int(v) for v in rng.integers(24, 220, 2))
        g = rng.integers(0, 256, (h, w), dtype=np.uint8)
        if k % 3 == 1:
            g = cv2.GaussianBlur(g, (0, 0), 2.0)
        elif k % 3 == 2:
            g = (g // 64 * 64).astype(np.uint8)
        out.append(g)
    return out


# --------------------------------------------------------------------------
# the dataset
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["once", "deterministic", "random"])
def test_dataset_matches_jax(models, f32_policies, data_dir, method):  # noqa: F811
    """varsize buckets, the alpha weights, flips, the three latent
    sampling methods and the batches drawn after them."""
    jm, pm = models
    kw = dict(varsize=True, use_weight=True, flip_p=0.5, shuffle_tags=True, tag_drop_out=0.2,
              template="subject_filewords", placeholder="tok", latent_sampling_method=method,
              seed=4)
    ref = jax_ds.PersonalizedDataset(str(data_dir), jm, **kw)
    out = port_ds.PersonalizedDataset(str(data_dir), pm, **kw)
    assert len(out) == len(ref) == 4 and list(out.buckets) == list(ref.buckets)
    for e, r in zip(out.entries, ref.entries):
        assert (e.filename, e.filename_text, e.bucket) == (r.filename, r.filename_text, r.bucket)
        lat = e.latent.numpy().transpose(1, 2, 0)
        assert lat.shape == r.latent.shape and _rel(lat, r.latent) <= 1e-5
        np.testing.assert_array_equal(e.weight.numpy().transpose(1, 2, 0), r.weight)
    for _ in range(3):
        lat, texts, weights = out.sample_batch(2)
        rlat, rtexts, rweights = ref.sample_batch(2)
        assert texts == rtexts
        assert _rel(lat.numpy().transpose(0, 2, 3, 1), rlat) <= 1e-5
        np.testing.assert_array_equal(weights.numpy().transpose(0, 2, 3, 1), rweights)


def test_dataset_reads_png_only(models, tmp_path):  # noqa: F811
    """PNG and JPEG files are read (a JPEG as Pillow decodes it), and a
    BMP and a WebP; a file in a format the port does not read (an AVIF
    under a .bmp name) raises naming the file and its format."""
    import io

    jpg = np.random.default_rng(4).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(jpg).save(buf, "JPEG", quality=80)
    (tmp_path / "a.png").write_bytes(encode_png(np.zeros((64, 64, 3), np.uint8)))
    (tmp_path / "b.jpg").write_bytes(buf.getvalue())
    np.testing.assert_array_equal(port_ds.read_image(str(tmp_path / "b.jpg")),
                                  np.asarray(Image.open(tmp_path / "b.jpg")))
    ds = port_ds.PersonalizedDataset(str(tmp_path), models[1], width=64, height=64)
    assert len(ds.entries) == 2
    for name, fmt in (("c.bmp", "BMP"), ("d.webp", "WEBP")):
        buf = io.BytesIO()
        Image.fromarray(jpg).save(buf, fmt, **({"lossless": True} if fmt == "WEBP" else {}))
        (tmp_path / name).write_bytes(buf.getvalue())
        np.testing.assert_array_equal(port_ds.read_image(str(tmp_path / name)), jpg)
    ds = port_ds.PersonalizedDataset(str(tmp_path), models[1], width=64, height=64)
    assert len(ds.entries) == 4
    (tmp_path / "e.bmp").write_bytes(b"\x00\x00\x00\x1cftypavif" + bytes(20))
    with pytest.raises(NotImplementedError, match=r"e\.bmp: a AVIF image"):
        port_ds.PersonalizedDataset(str(tmp_path), models[1], width=64, height=64)


# --------------------------------------------------------------------------
# cv2 and Pillow restatements
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_good_features_to_track_equals_cv2(seed):
    for g in _images(seed):
        np.testing.assert_array_equal(port_cv.corner_min_eigen_val(g),
                                      cv2.cornerMinEigenVal(g, 3, 3))
        ref = cv2.goodFeaturesToTrack(g, maxCorners=50, qualityLevel=0.04, minDistance=10)
        out = port_cv.good_features_to_track(g, 50, 0.04, 10)
        if ref is None:
            assert out is None
        else:
            np.testing.assert_array_equal(out, ref)
    flat = np.full((40, 40), 7, np.uint8)
    assert port_cv.good_features_to_track(flat, 50, 0.04, 10) is None is \
        cv2.goodFeaturesToTrack(flat, maxCorners=50, qualityLevel=0.04, minDistance=10)


def test_rgb_to_gray_equals_cv2():
    g = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    for b in range(0, 256, 15):
        img = np.concatenate([g, np.full(g.shape[:2] + (1,), b)], -1).astype(np.uint8)
        np.testing.assert_array_equal(port_cv.rgb_to_gray(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("seed", [0, 1])
def test_resize_with_a_box_equals_pillow(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        h, w = (int(v) for v in rng.integers(20, 200, 2))
        tw, th = (int(v) for v in rng.integers(16, 160, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        x0, y0 = float(rng.uniform(0, w / 3)), float(rng.uniform(0, h / 3))
        box = (x0, y0, float(rng.uniform(x0 + 4, w)), float(rng.uniform(y0 + 4, h)))
        for name, rs in (("lanczos", Image.LANCZOS), ("bicubic", Image.BICUBIC)):
            ref = np.asarray(Image.fromarray(img).resize((tw, th), rs, box))
            np.testing.assert_array_equal(port_images.resize(img, (tw, th), name, box), ref)


# --------------------------------------------------------------------------
# the crops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(300, 90), (90, 300), (100, 120), (513, 128)])
def test_split_and_crops_match_jax(shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    pil = Image.fromarray(img)
    ref = jax_pre.split_oversized(pil, 64, 96, 0.2, 2.0)
    out = port_pre.split_oversized(img, 64, 96, 0.2, 2.0)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, np.asarray(r))
    for w, h in ((64, 64), (48, 80)):
        np.testing.assert_array_equal(port_pre.center_crop(img, w, h),
                                      np.asarray(jax_pre.center_crop(pil, w, h)))
    for kw in ({}, {"mindim": 64, "maxdim": 192, "objective": "Minimize error"}):
        ref, out = jax_pre.autosized_crop(pil, **kw), port_pre.autosized_crop(img, **kw)
        assert (ref is None) == (out is None)
        if ref is not None:
            np.testing.assert_array_equal(out, np.asarray(ref))


def _no_faces(img):
    """JAX's cascade finds no face in img, so its face points stay out of
    both: this cv2 has no cascade evaluator at all (JAX's call raises
    inside its try), or the cascade finds none."""
    cascade = os.path.join(getattr(getattr(cv2, "data", None), "haarcascades", ""),
                           "haarcascade_frontalface_default.xml")
    if not hasattr(cv2, "CascadeClassifier") or not os.path.isfile(cascade):
        return True
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    return len(cv2.CascadeClassifier(cascade).detectMultiScale(gray, 1.1, 4)) == 0


@pytest.mark.parametrize("size", [(150, 100, 64, 64), (90, 240, 96, 64), (64, 64, 64, 64)])
def test_autocrop_matches_jax(size):
    h, w, cw, ch = size
    rng = np.random.default_rng(h + w)
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 1.5)
    img[h // 3: h // 2, w // 4: w // 2] = 255
    scale = max(cw / w, ch / h)
    big = np.asarray(Image.fromarray(img).resize((max(int(w * scale), cw),
                                                  max(int(h * scale), ch)), Image.BICUBIC))
    assert _no_faces(big)
    np.testing.assert_array_equal(port_ds.autocrop_image(img, cw, ch),
                                  np.asarray(jax_ds.autocrop_image(Image.fromarray(img), cw, ch)))


# --------------------------------------------------------------------------
# the directory pass
# --------------------------------------------------------------------------

@pytest.fixture
def tiny_booru(tmp_path, monkeypatch):
    """A TorchDeepDanbooru file at TINY_PLAN with its tags in it and in the
    sidecar JAX reads, both loaders held to the reduced plan."""
    tags = ["red_fox", "rating:safe", "cat_(animal)", "blue", "big_dog"]
    directory = tmp_path / "booru"
    directory.mkdir()
    sd = port_db.random_state_dict(tags, seed=3, plan=TINY_PLAN, stem=4)
    torch.save(sd, directory / "tiny.pt")
    (directory / "tiny.tags.txt").write_text("\n".join(tags))
    real_port = port_db.load_deepbooru
    monkeypatch.setattr(port_db, "load_deepbooru",
                        lambda path, device="cuda", plan=None: real_port(path, device, TINY_PLAN))

    def jax_load(path):
        params, _ = jax_db.convert_deepbooru(
            {k: v.numpy() for k, v in sd.items() if k != "tags"}, plan=TINY_PLAN)
        return params, tags

    monkeypatch.setattr(jax_db, "load_deepbooru", jax_load)
    monkeypatch.setattr(jax_db, "_PLAN", list(TINY_PLAN))
    return directory


@pytest.mark.parametrize("action", ["ignore", "prepend", "copy"])
def test_preprocess_dir_matches_jax(tmp_path, tiny_booru, monkeypatch, action):
    """split → focal crop → flip → DeepDanbooru captions: the same files,
    pixels and captions as JAX's pass."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    for name, shape in (("wide.png", (80, 260)), ("tall.png", (250, 70)), ("sq.png", (90, 90))):
        img = cv2.GaussianBlur(rng.integers(0, 256, shape + (3,), dtype=np.uint8), (0, 0), 1.0)
        (src / name).write_bytes(encode_png(img))
    (src / "sq.txt").write_text("a square")
    kw = dict(width=64, height=64, split=True, flip=True, focal_crop=True,
              caption_deepbooru=True, existing_caption_action=action)
    monkeypatch.chdir(tmp_path)
    os.makedirs("models", exist_ok=True)
    os.symlink(tiny_booru, "models/torch_deepdanbooru")
    threshold = {"interrogate_deepbooru_score_threshold": 0.5}
    from sdwebui_tpu.utils.options import opts as jax_opts
    from sdwebui_tpu_torch.utils.options import opts

    with jax_opts.override(threshold), opts.override(threshold):
        ref = jax_pre.preprocess_dir(str(src), str(tmp_path / "j"), **kw)
        out = port_pre.preprocess_dir(str(src), str(tmp_path / "p"), device="cpu", **kw)
    assert [os.path.basename(p) for p in out] == [os.path.basename(p) for p in ref]
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    for p, r in zip(out, ref):
        with open(p, "rb") as f:
            np.testing.assert_array_equal(decode_png(f.read())[0], np.asarray(Image.open(r)))
    for f in os.listdir(tmp_path / "j"):
        if f.endswith(".txt"):
            assert (tmp_path / "p" / f).read_text() == (tmp_path / "j" / f).read_text()
    assert any(f.endswith(".txt") for f in os.listdir(tmp_path / "p"))


def test_preprocess_reads_png_only(tmp_path):
    """A file in a format the port does not read (an AVIF under a .webp
    name) raises naming it; WebP and BMP inputs are in test_torch_formats."""
    (tmp_path / "a.webp").write_bytes(b"\x00\x00\x00\x1cftypavif" + bytes(20))
    with pytest.raises(NotImplementedError, match="a AVIF image"):
        port_pre.preprocess_dir(str(tmp_path), str(tmp_path / "out"), device="cpu")
