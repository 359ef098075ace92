"""JPEG 2000 on the routes JAX's Pillow serves it, against JAX.

A .jp2 and a .j2k as an img2img init image (within 1 level of JAX's
pipeline on the image JAX's route decodes, the same infotext), in every
image field (the answer the PNG of the same pixels gets), inside an ICNS
file, in the img2img batch directory (JAX's outputs); txt2img with
``samples_format`` jp2 and ``grid_format`` j2k (JAX's file names, its
writer's bytes for the port's pixels); a SIZ bomb, a 150 MP codestream
of no data and an HTJ2K codestream answer 400."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import torch_image_files as f
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.server import app as jax_app
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.utils import saving
from sdwebui_tpu_torch.utils.image_io import read_image_file
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import f32_policies, models  # noqa: F401
from test_torch_save_routes import _jax_self
from test_torch_saving import both, fixed_clock  # noqa: F401

ROUTES = [("/sdapi/v1/img2img", "init_images"), ("/sdapi/v1/img2img", "mask"),
          ("/sdapi/v1/extra-single-image", "image"), ("/sdapi/v1/png-info", "image")]


def _image(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:64, 0:64]
    return np.clip(np.stack([x * 3 + seed * 20, y * 3, (x + y) * 2], 2)
                   + rng.integers(0, 12, (64, 64, 3)), 0, 255).astype(np.uint8)


def _jpeg2000(a: np.ndarray, kind: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG2000", no_jp2=kind == "j2k")
    return buf.getvalue()


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


@pytest.fixture(scope="module")
def port_api(models):  # noqa: F811
    return Api(Engine(model=models[1], device="cpu", hash_cache=None))


def _body(route: str, field: str, payload: str) -> dict:
    if route.endswith("img2img"):
        body = {"init_images": [_b64(encode_png(_image()))], "steps": 1, "width": 64,
                "height": 64, "seed": 5, "inpaint_full_res": False}
    elif "extra" in route:
        body = {"upscaler_1": "Lanczos", "upscaling_resize": 1.5}
    else:
        body = {}
    body[field] = [payload] if field == "init_images" else payload
    return body


@pytest.mark.parametrize("kind", ["jp2", "j2k"])
def test_img2img_init_image_matches_jax(models, f32_policies, port_api, both, kind):  # noqa: F811
    both(sdtpu_vae_bf16=False)
    b64 = _b64(_jpeg2000(_image(1), kind))
    kw = dict(prompt="a cat", seed=13, steps=2, width=64, height=64, denoising_strength=0.7)
    ref = jax_i2i.process_img2img(models[0], JaxParams(
        init_images=[jax_app.decode_base64_to_image(b64)], **kw))
    status, out = port_api.handle("POST", "/sdapi/v1/img2img", dict(kw, init_images=[b64]))
    assert status == 200, out
    got, text = decode_png(base64.b64decode(out["images"][0]))
    assert np.abs(got.astype(int) - np.asarray(ref.images[0], int)).max() <= 1
    assert text["parameters"] == ref.infotexts[0]


@pytest.mark.parametrize("wrapper", ["j2k", "icns"])
@pytest.mark.parametrize("route,field", ROUTES)
def test_image_fields_read_jpeg2000(port_api, route, field, wrapper):
    """A raw codestream, and a JPEG 2000 entry of an ICNS file, in every
    image field: the answer the PNG of the same pixels gets (a .jp2 is
    test_torch_formats_rare's)."""
    src = _image(2)[:32, :32] if wrapper == "icns" else _image(2)
    if field == "mask":
        src = np.zeros_like(src)
        src[8:24, 8:24] = 255
    data = _jpeg2000(src, "j2k")
    if wrapper == "icns":
        data = f.icns_file(None, kind=b"icp5", png=data)       # Pillow's 32×32 entry
        src = np.concatenate([src, np.full(src.shape[:2] + (1,), 255, np.uint8)], 2)
    answers = []
    for payload in (data, encode_png(src)):
        status, out = port_api.handle("POST", route, _body(route, field, _b64(payload)))
        assert status == 200, out
        answers.append(out.get("images") or out.get("image") or out.get("info"))
    assert answers[0] == answers[1]


def test_img2img_batch_matches_jax(models, f32_policies, port_api, tmp_path, both,  # noqa: F811
                                   fixed_clock):  # noqa: F811
    """A .jp2 and a .j2k under the batch's .png and .jpg names: the port's
    outputs and infotexts are JAX's (within 1 level)."""
    both(sdtpu_vae_bf16=False)
    src = tmp_path / "in"
    src.mkdir()
    (src / "a.png").write_bytes(_jpeg2000(_image(3), "jp2"))
    (src / "b.jpg").write_bytes(_jpeg2000(_image(4), "j2k"))
    body = {"input_dir": str(src), "prompt": "base", "seed": 9, "steps": 2, "width": 64,
            "height": 64, "denoising_strength": 0.6}
    ref = jax_api.Api.img2img_batch(_jax_self(models[0]),
                                    dict(body, output_dir=str(tmp_path / "jax")))
    status, out = port_api.handle("POST", "/internal/img2img-batch",
                                  dict(body, output_dir=str(tmp_path / "port")))
    assert status == 200, out
    assert out["processed"] == ref["processed"] == 2
    for ours, theirs in zip(out["outputs"], ref["outputs"]):
        assert os.path.basename(ours) == os.path.basename(theirs)
        img, text = decode_png(open(ours, "rb").read())
        with Image.open(theirs) as im:
            assert np.abs(img.astype(int) - np.asarray(im, int)).max() <= 1
            assert text["parameters"] == im.info["parameters"]


def test_txt2img_samples_jp2_grid_j2k_as_jax(models, f32_policies, tmp_path, both,  # noqa: F811
                                             fixed_clock):  # noqa: F811
    """samples_format jp2 and grid_format j2k: JAX's file names (JAX writes
    its samples as PNG whatever samples_format says: ROADMAP C); each of the
    port's files is what JAX's writer makes of the port's pixels (JP2 for
    both: the write goes through a .tmp name) and within 1 level of JAX's
    file."""
    both(sdtpu_vae_bf16=False, samples_format="jp2", grid_format="j2k",
         sdtpu_async_save=False)
    kw = dict(prompt="a red cat", seed=31, steps=2, width=64, height=64, batch_size=2)
    for which, mod, proc, model in (("jax", JaxParams, jax_proc, models[0]),
                                    ("port", GenerationParams, port_proc, models[1])):
        p = mod(**kw)
        p.outpath_grids = str(tmp_path / which / "grids")
        proc.process_txt2img(model, p, outdir=str(tmp_path / which / "samples"))
    jax_images.flush_saves()
    saving.flush_saves()
    tree = {w: {os.path.relpath(os.path.join(r, n), tmp_path / w): os.path.join(r, n)
                for r, _, fs in os.walk(tmp_path / w) for n in fs} for w in ("jax", "port")}
    as_jax = {n if n.startswith("grids") else n.replace(".jp2", ".png"): n for n in tree["port"]}
    assert sorted(as_jax) == sorted(tree["jax"])
    assert sorted(os.path.splitext(n)[1] for n in tree["port"]) == [".j2k", ".jp2", ".jp2"]
    for jax_name, name in as_jax.items():
        path = tree["port"][name]
        mine = open(path, "rb").read()
        px = read_image_file(path)[0]
        with Image.open(tree["jax"][jax_name]) as im:
            assert np.abs(px.astype(int) - np.asarray(im.convert("RGB"), int)).max() <= 1, name
        # JAX's save_image writes through "<name>.tmp": Pillow, deciding by
        # that name, writes JP2 boxes under .j2k too
        again = tmp_path / "again.tmp"
        jax_images.save_image_with_geninfo(Image.fromarray(px), None, str(again),
                                           extension=os.path.splitext(name)[1])
        assert mine == again.read_bytes(), name
        assert mine.startswith(b"\x00\x00\x00\x0cjP  ")
        assert open(tree["jax"][jax_name], "rb").read(12) == mine[:12] or jax_name.endswith(".png")


def _siz_bomb() -> bytes:
    data = bytearray(_jpeg2000(_image(5)[:8, :8], "jp2"))
    o = data.index(b"\xff\x51")
    struct.pack_into(">II", data, o + 6, 60000, 60000)
    o = data.index(b"ihdr")
    struct.pack_into(">II", data, o + 4, 60000, 60000)
    return bytes(data)


@pytest.mark.parametrize("route,field", ROUTES)
def test_siz_bomb_answers_400(port_api, route, field):
    """A SIZ of 60000² (more than twice Pillow's MAX_IMAGE_PIXELS) answers
    400 before anything of its size is allocated, as JAX's Image.open
    refuses it."""
    import tracemalloc

    data = _siz_bomb()
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    tracemalloc.start()
    try:
        status, res = port_api.handle("POST", route, _body(route, field, _b64(data)))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert status == 400 and "decompression bomb" in res["detail"], res
    assert peak < 16 << 20


@pytest.mark.parametrize("route,field", ROUTES)
def test_empty_tile_of_150_mp_answers_400(port_api, route, field):
    """A codestream of a few bytes declaring some 150 MP (under the bomb
    limit) in 4×4 code-blocks over a tile of no data: JAX's Pillow fails
    such a tile (held here at 64×48: at 150 MP OpenJPEG takes some 12 GB
    before it fails), and the port answers 400 before allocating anything
    of the declared size."""
    import tracemalloc

    from test_torch_jpeg2000 import BIG_SIDE, empty_codestream

    with pytest.raises(OSError):
        Image.open(io.BytesIO(empty_codestream(64, 48, 3, b""))).load()
    data = empty_codestream(BIG_SIDE, BIG_SIDE, 3, b"")
    tracemalloc.start()
    try:
        status, res = port_api.handle("POST", route, _body(route, field, _b64(data)))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert status == 400, res
    assert peak < 16 << 20


@pytest.mark.parametrize("route,field", ROUTES)
def test_htj2k_answers_400_naming_part_15(port_api, route, field):
    data = _jpeg2000(_image(6), "j2k")
    o = 4 + struct.unpack_from(">H", data, 4)[0]
    data = data[:o] + b"\xff\x50" + struct.pack(">HIH", 8, 1 << 17, 0) + data[o:]
    status, res = port_api.handle("POST", route, _body(route, field, _b64(data)))
    assert status == 400 and "Part 15" in res["detail"], res
