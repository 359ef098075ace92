"""Shared set-up of the scripts' parity tests: a JAX ``Engine`` and a port
``Engine`` serving one tiny SD1.5 (the JAX tiny model carried across by
``sd_model.from_jax``), a script run through JAX's ``run_script`` and the
port's generation route, and the comparison: images within 1 uint8 level,
identical infotexts."""

import base64
import json
from types import SimpleNamespace

import numpy as np
from PIL import Image

import sdwebui_tpu.scripts.builtin  # noqa: F401  (registers JAX's scripts)
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.server.app import Engine as JaxEngine
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import _init_image

#: the request every case starts from: 64², 2 steps, Euler a, f32 decode
BASE = dict(prompt="a cat, blue, fluffy", negative_prompt="ugly", seed=3, steps=2,
            width=64, height=64, override_settings={"sdtpu_vae_bf16": False})


def make_engines(models, tmp_path, allow_code: bool = False):
    """(JAX Engine, port Engine) over the pair of tiny models."""
    jm, pm = models
    jax_engine = JaxEngine(test_model=True)
    jax_engine._model = jm
    port_engine = Engine(model=pm, device="cpu", hash_cache=None,
                         styles_path=str(tmp_path / "styles.csv"), allow_code=allow_code)
    return jax_engine, port_engine


def params(img2img: bool = False, **kw):
    """(JAX params, port params) of one request: BASE updated with kw, each
    side with its own dicts; img2img adds the blocky init image (a PIL image
    for JAX, the uint8 array for the port) at denoising strength 0.6."""
    base = dict(BASE, **kw)
    sides = []
    for cls in (JaxParams, GenerationParams):
        fields = dict(base, override_settings=dict(base["override_settings"]))
        if img2img:
            init = fields.pop("init", None)
            init = _init_image() if init is None else init
            fields["init_images"] = [Image.fromarray(init) if cls is JaxParams else init]
            fields.setdefault("denoising_strength", 0.6)
        sides.append(cls(**fields))
    return tuple(sides)


def as_arrays(images) -> list:
    return [np.asarray(im.convert("RGB")) if isinstance(im, Image.Image) else im
            for im in images]


def assert_same(ref, out):
    """Every image within 1 uint8 level of JAX's, the infotexts equal."""
    ref_imgs, out_imgs = as_arrays(ref.images), list(out.images)
    assert len(out_imgs) == len(ref_imgs)
    for a, b in zip(out_imgs, ref_imgs):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts
    assert (out.seed, out.all_seeds, out.all_prompts) == (ref.seed, ref.all_seeds,
                                                          ref.all_prompts)
    return out_imgs


def run_route(port_engine, name, args, img2img: bool = False, **kw):
    """The script through the port's /sdapi/v1/txt2img or /img2img route
    (the request as ``params`` builds it, as JSON): its decoded PNGs, their
    infotexts and the info's seeds and prompts."""
    body = dict(BASE, **kw, script_name=name, script_args=list(args))
    if img2img:
        init = body.pop("init", None)
        init = _init_image() if init is None else init
        body["init_images"] = [base64.b64encode(encode_png(init)).decode()]
        body.setdefault("denoising_strength", 0.6)
    route = "/sdapi/v1/img2img" if img2img else "/sdapi/v1/txt2img"
    status, res = Api(port_engine).handle("POST", route, json.loads(json.dumps(body)))
    assert status == 200, res
    info = json.loads(res["info"])
    decoded = [decode_png(base64.b64decode(b)) for b in res["images"]]
    assert [text["parameters"] for _, text in decoded] == info["infotexts"]
    return SimpleNamespace(images=[img for img, _ in decoded], infotexts=info["infotexts"],
                           seed=info["seed"], all_seeds=info["all_seeds"],
                           all_prompts=info["all_prompts"])


def run_both(engines, name, args, img2img: bool = False, **kw):
    """The script through JAX's run_script and the port's route: (JAX
    result, port result), checked equal."""
    jax_engine, port_engine = engines
    ref = jax_engine.run_script(name, params(img2img, **kw)[0], list(args))
    out = run_route(port_engine, name, args, img2img, **kw)
    assert_same(ref, out)
    return ref, out
