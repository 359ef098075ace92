"""The scripts framework in the port against the JAX package's: the
registry and every script's ui_params, ``validate_script_args`` over a
table of bad arguments, the grid with explicit rows, images of unequal
size and the ``image_grid`` callback, the hook sequence an always-on
script sees through txt2img (with and without hires fix), img2img and
inpainting, the sd_unet slot, the job state of a script, and the routes:
``/sdapi/v1/scripts`` and ``/sdapi/v1/script-info`` as JAX answers them,
``script_name`` dispatched from both generation routes over HTTP, and the
400s and 422s.  Generations run on one tiny SD1.5 carried across by
``from_jax`` (64², f32, 2 steps): images within 1 uint8 level, identical
infotexts."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)

import base64
import copy
import dataclasses
import json
import logging
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.pipeline import sd_unet as jax_sd_unet
from sdwebui_tpu.scripts import framework as jax_fw
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.server import cmd_flags
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu.utils.pytree import flatten, unflatten
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_unet
from sdwebui_tpu_torch.scripts import framework
from sdwebui_tpu_torch.server.api import Api, make_server
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import _init_image, _rect_mask, f32_policies, models  # noqa: F401
from torch_scripts_common import BASE, as_arrays, assert_same, make_engines, params


@pytest.fixture
def engines(models, f32_policies, tmp_path):  # noqa: F811
    return make_engines(models, tmp_path)


# --------------------------------------------------------------------------
# the registry and argument validation
# --------------------------------------------------------------------------

def test_registry_and_ui_params_equal_jax():
    assert framework.list_selectable_scripts() == jax_fw.list_selectable_scripts()
    assert framework.list_alwayson_scripts() == jax_fw.list_alwayson_scripts()
    assert framework.CALLBACK_CHANNELS == jax_fw.CALLBACK_CHANNELS
    for name in jax_fw.list_selectable_scripts() + jax_fw.list_alwayson_scripts():
        assert framework.get_script(name).ui_params == jax_fw.get_script(name).ui_params, name
    assert framework.get_script("no such script") is None


BAD_ARGS = [
    ("Loopback", ["four"]),
    ("Loopback", [True]),
    ("Loopback", [4, 0.5, "Steep"]),
    ("Loopback", [4, 0.5, 7]),
    ("Loopback", [4, 0.5, "Linear", 1]),
    ("Prompts from file or textbox", ["yes"]),
    ("Prompts from file or textbox", [False, False, ["a", "b"]]),
    ("SD upscale", [64, 3.5]),
    ("X/Y/Z plot", ["No axis"]),
    ("X/Y/Z plot", [1, "1-2", "not a list"]),
    ("X/Y/Z plot", [99, "1-2", []]),
    ("X/Y/Z plot", [1, "1-2", [], 0, "", [], 0, "", [], False, False, False, False, 1]),
    ("X/Y/Z plot", [{"x": 1}, "1-2", []]),
]


@pytest.mark.parametrize("name,args", BAD_ARGS)
def test_validate_script_args_raises_as_jax(name, args):
    """The same argument index, label and message as JAX's."""
    with pytest.raises(jax_fw.ScriptArgError) as ref:
        jax_fw.validate_script_args(jax_fw.get_script(name), args)
    with pytest.raises(framework.ScriptArgError) as out:
        framework.validate_script_args(framework.get_script(name), args)
    assert (out.value.index, out.value.label, str(out.value)) == \
        (ref.value.index, ref.value.label, str(ref.value))


@pytest.mark.parametrize("name,args", [
    ("Loopback", [4, "0.5", "Lazy"]), ("Loopback", [None, None, 2]),
    ("X/Y/Z plot", ["Seed", "1-2", "Steps", "2,3", "Nothing", "", False, False]),
    ("X/Y/Z plot", [1, "1-2", [], 0, "", [], 0, "", [], False, False, False, False]),
    ("Custom code", ["x = 1", 0]), ("SD upscale", [64, "R-ESRGAN 4x+", 2])])
def test_validate_script_args_passes_as_jax(name, args):
    jax_fw.validate_script_args(jax_fw.get_script(name), args)
    framework.validate_script_args(framework.get_script(name), args)


def test_bad_axis_values_name_the_axis(engines):
    for engine, error in zip(engines, (jax_fw.ScriptArgError, framework.ScriptArgError)):
        with pytest.raises(error, match="X values") as e:
            engine.run_script("X/Y/Z plot", params()[engine is engines[1]],
                              ["Steps", "2, many", "Nothing", "", "Nothing", "", False])
    assert "'Steps' expects numbers, got 'many'" in str(e.value)


# --------------------------------------------------------------------------
# the grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,rows,opt", [
    ([(64, 64)] * 5, None, {}), ([(64, 64)] * 6, 3, {}), ([(64, 64)] * 4, None, {"n_rows": 0}),
    ([(64, 64), (96, 64), (64, 96), (70, 50)], 2, {"grid_background_color": "#102030"}),
    ([(64, 64), (95, 63)], 1, {}), ([(30, 40)] * 7, None, {"grid_prevent_empty_spots": True}),
])
def test_image_grid_matches_jax(sizes, rows, opt):
    """Pixel-equal to JAX's Pillow grid: cells of the largest image, each
    image centred in its cell."""
    rng = np.random.default_rng(len(sizes))
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for w, h in sizes]
    with jax_opts.override(opt), opts.override(opt):
        ref = np.asarray(jax_images.image_grid([Image.fromarray(i) for i in imgs], 2, rows=rows))
        out = port_proc.image_grid(imgs, 2, rows=rows)
    np.testing.assert_array_equal(out, ref)


def test_image_grid_callback_sees_and_sets_the_layout():
    seen = []

    def one_row(params):
        seen.append((params.cols, params.rows, len(params.imgs)))
        params.cols, params.rows = len(params.imgs), 1

    framework.on("image_grid", one_row)
    jax_fw.on("image_grid", one_row)
    try:
        imgs = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(4)]
        out = port_proc.image_grid(imgs, 1)
        ref = np.asarray(jax_images.image_grid([Image.fromarray(i) for i in imgs], 1))
    finally:
        framework._callbacks["image_grid"].clear()
        jax_fw._callbacks["image_grid"].clear()
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (8, 32, 3) and seen == [(2, 2, 4), (2, 2, 4)]


def test_unknown_callback_channel_raises():
    with pytest.raises(ValueError, match="no_such_channel"):
        framework.on("no_such_channel", print)


# --------------------------------------------------------------------------
# the always-on hooks
# --------------------------------------------------------------------------

def _recorder(base, log, paint=None):
    """An always-on script of `base`'s package that records every hook it
    sees (with the arguments both packages give alike); `paint` colours
    each image in postprocess_image."""

    class Recorder(base):
        name = "recorder"
        alwayson = True

        def setup(self, p, *a):
            log.append(("setup",))

        def before_process(self, p, *a):
            log.append(("before_process",))

        def process(self, p, *a):
            log.append(("process",))

        def before_process_batch(self, p, *a, **kw):
            log.append(("before_process_batch", kw["batch_number"], tuple(kw["seeds"])))

        def after_extra_networks_activate(self, p, *a, **kw):
            log.append(("after_extra_networks_activate",))

        def process_before_every_sampling(self, p, *a, **kw):
            log.append(("process_before_every_sampling", kw["batch_number"],
                        kw.get("is_hr_pass", False)))

        def process_batch(self, p, *a, batch_number=0, seeds=None, **kw):
            log.append(("process_batch", batch_number, tuple(seeds)))

        def on_mask_blend(self, p, mba, *a):
            log.append(("on_mask_blend", int(np.prod(mba.nmask.shape))))

        def post_sample(self, p, ps, *a):
            log.append(("post_sample", int(np.prod(ps.samples.shape))))

        def postprocess_batch(self, p, *a, images=None, batch_number=0):
            log.append(("postprocess_batch", batch_number, len(images)))

        def postprocess_batch_list(self, p, pp, *a, **kw):
            log.append(("postprocess_batch_list", len(pp.images)))

        def postprocess_image(self, p, image, *a):
            log.append(("postprocess_image",))
            if paint is None:
                return image
            return paint(image)

        def postprocess_maskoverlay(self, p, ppmo, *a):
            log.append(("postprocess_maskoverlay", ppmo.index))

        def postprocess_image_after_composite(self, p, pp, *a):
            log.append(("postprocess_image_after_composite", pp.index))

        def postprocess(self, p, processed, *a):
            log.append(("postprocess", len(processed.images)))

    return Recorder()


HOOK_CASES = {
    "txt2img": (False, dict(batch_size=2, n_iter=2)),
    "txt2img_hires": (False, dict(enable_hr=True, hr_scale=1.5, denoising_strength=0.6)),
    "img2img": (True, {}),
    "inpaint": (True, dict(mask=True, inpainting_fill=1)),
}


@pytest.mark.parametrize("case", list(HOOK_CASES))
def test_hook_sequence_matches_jax(engines, case):
    """The hooks, their order and their arguments equal JAX's, and the
    images and infotexts too."""
    jax_engine, port_engine = engines
    img2img, kw = HOOK_CASES[case]
    kw = dict(kw)
    mask = kw.pop("mask", False)
    jp, pp = params(img2img, **kw)
    if mask:
        jp.mask, pp.mask = Image.fromarray(_rect_mask()), _rect_mask()
    jax_log, port_log = [], []
    jax_rec, port_rec = _recorder(jax_fw.Script, jax_log), _recorder(framework.Script, port_log)
    jax_fw.get_runner().add(jax_rec)
    framework.get_runner().add(port_rec)
    try:
        run = "img2img_inner" if img2img else "txt2img_inner"
        ref = getattr(jax_engine, run)(jp)
        out = getattr(port_engine, run)(pp)
    finally:
        jax_fw.get_runner().alwayson_scripts.remove(jax_rec)
        framework.get_runner().alwayson_scripts.remove(port_rec)
    assert_same(ref, out)
    assert port_log == jax_log
    names = [entry[0] for entry in port_log]
    assert names[:4] == ["setup", "before_process", "after_extra_networks_activate", "process"]
    assert names[-1] == "postprocess"
    if mask:
        assert {"on_mask_blend", "postprocess_maskoverlay"} <= set(names)


def test_postprocess_image_replaces_the_image_before_the_grid(engines):
    """A script's postprocess_image output is the image returned, and the
    grid is built from it (a failing hook is logged, the job goes on)."""
    jax_engine, port_engine = engines
    jax_rec = _recorder(jax_fw.Script, [], lambda im: Image.new("RGB", im.size, (255, 0, 0)))
    red = np.zeros((64, 64, 3), np.uint8)
    red[..., 0] = 255
    port_rec = _recorder(framework.Script, [], lambda im: red)
    jax_fw.get_runner().add(jax_rec)
    framework.get_runner().add(port_rec)
    try:
        jp, pp = params(batch_size=2)
        jp.do_not_save_grid = pp.do_not_save_grid = False
        ref = jax_engine.txt2img_inner(jp)
        out = port_engine.txt2img_inner(pp)
    finally:
        jax_fw.get_runner().alwayson_scripts.remove(jax_rec)
        framework.get_runner().alwayson_scripts.remove(port_rec)
    assert_same(ref, out)
    assert len(out.images) == 3 and all((im == red[0, 0]).all() for im in out.images)


def test_a_failing_hook_is_logged_and_the_job_goes_on(engines, caplog):
    port_engine = engines[1]

    class Broken(framework.Script):
        name = "broken"
        alwayson = True

        def process(self, p, *a):
            raise RuntimeError("hook fault")

    broken = Broken()
    framework.get_runner().add(broken)
    try:
        with caplog.at_level(logging.ERROR, logger="sdwebui_tpu_torch.scripts.framework"):
            out = port_engine.txt2img_inner(params()[1])
    finally:
        framework.get_runner().alwayson_scripts.remove(broken)
    assert len(out.images) == 1
    assert "hook process failed" in caplog.text and "hook fault" in caplog.text


# --------------------------------------------------------------------------
# the sd_unet slot
# --------------------------------------------------------------------------

def test_sd_unet_provider_matches_jax(engines):
    """A provider on list_unets, selected by opts.sd_unet, against JAX's: the
    negated UNet's images within 1 level of JAX's, unlike Automatic's, and
    the served model untouched."""
    jax_engine, port_engine = engines

    def jax_negated(model):
        flat = {k: -v for k, v in flatten(model.unet_params).items()}
        return dataclasses.replace(model, unet_params=unflatten(flat))

    def port_negated(model):
        unet = copy.deepcopy(model.unet)
        with torch.no_grad():
            for prm in unet.parameters():
                prm.neg_()
        return dataclasses.replace(model, unet=unet)

    jax_fw.on("list_unets", lambda lst: lst.append(jax_sd_unet.SdUnetOption("negated",
                                                                             jax_negated)))
    framework.on("list_unets", lambda lst: [sd_unet.SdUnetOption("negated", port_negated)])
    try:
        assert [o.label for o in sd_unet.refresh_unet_list()] == ["negated"]
        assert sd_unet.unet_labels() == ["Automatic", "None", "negated"]
        base = port_engine.txt2img_inner(params()[1])
        jp, pp = params(override_settings=dict(BASE["override_settings"], sd_unet="negated"))
        ref = jax_engine.txt2img_inner(jp)
        out = port_engine.txt2img_inner(pp)
        assert_same(ref, out)
        assert np.abs(out.images[0].astype(int) - base.images[0].astype(int)).max() > 0
        again = port_engine.txt2img_inner(params()[1])
        np.testing.assert_array_equal(again.images[0], base.images[0])
    finally:
        jax_fw._callbacks["list_unets"].clear()
        framework._callbacks["list_unets"].clear()


def test_unknown_sd_unet_logs_once_and_runs_the_checkpoints(engines, caplog):
    port_engine = engines[1]
    base = port_engine.txt2img_inner(params()[1])
    ov = dict(BASE["override_settings"], sd_unet="no-such-unet")
    with caplog.at_level(logging.WARNING, logger="sdwebui_tpu_torch.pipeline.sd_unet"):
        for _ in range(2):
            out = port_engine.txt2img_inner(params(override_settings=ov)[1])
            np.testing.assert_array_equal(out.images[0], base.images[0])
    assert caplog.text.count("no provider named 'no-such-unet'") == 1


# --------------------------------------------------------------------------
# the job of a script
# --------------------------------------------------------------------------

def test_one_job_for_the_whole_script(engines):
    """state.begin runs once, "script:<name>", and every cell's steps run
    inside it (JAX's app.py:406); the job ends after the last cell."""
    port_engine = engines[1]
    begun, jobs = [], []
    real_begin, real_step = port_engine.state.begin, port_engine._step_callback

    def begin(job, *a, **kw):
        begun.append(job)
        return real_begin(job, *a, **kw)

    def step(i, n, latents):
        jobs.append(port_engine.state.job)
        return real_step(i, n, latents)

    port_engine.state.begin, port_engine._step_callback = begin, step
    port_engine.run_script("X/Y/Z plot", params()[1],
                           ["Seed", "1-3", "Nothing", "", "Nothing", "", False])
    assert begun == ["script:X/Y/Z plot"]
    assert jobs == ["script:X/Y/Z plot"] * 6 and port_engine.state.job == ""


# --------------------------------------------------------------------------
# the routes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("allow_code", [False, True])
def test_script_routes_answer_as_jax(engines, allow_code):
    jax_engine, port_engine = engines
    port_engine.allow_code = allow_code
    cmd_flags.cmd_opts = type(cmd_flags.cmd_opts)()
    cmd_flags.cmd_opts.allow_code = allow_code
    try:
        ref_api = jax_api.Api(jax_engine)
        api = Api(port_engine)
        for path, ref in (("/sdapi/v1/scripts", ref_api.scripts()),
                          ("/sdapi/v1/script-info", ref_api.script_info())):
            status, out = api.handle("GET", path, None)
            assert status == 200 and json.loads(json.dumps(out)) == json.loads(json.dumps(ref))
    finally:
        cmd_flags.cmd_opts = type(cmd_flags.cmd_opts)()
    names = api.handle("GET", "/sdapi/v1/scripts", None)[1]["txt2img"]
    assert ("custom code" in names) == allow_code and "x/y/z plot" in names


def _b64(img) -> str:
    return base64.b64encode(encode_png(img)).decode()


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_script_name_dispatches_from_both_routes_over_http(engines):
    """X/Y/Z from /txt2img and loopback from /img2img: each image's PNG and
    infotext as JAX's run_script makes them."""
    jax_engine, port_engine = engines
    server = make_server(port_engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        xyz = ["Seed", "1-2", "Nothing", "", "Nothing", "", False]
        status, res = _post(url, "/sdapi/v1/txt2img", dict(BASE, script_name="X/Y/Z plot",
                                                           script_args=xyz))
        assert status == 200, res
        ref = jax_engine.run_script("X/Y/Z plot", params()[0], xyz)
        loop = [1, 0.5, "Linear"]
        status, res2 = _post(url, "/sdapi/v1/img2img", dict(
            BASE, script_name="loopback", script_args=loop, init_images=[_b64(_init_image())],
            denoising_strength=0.6))
        assert status == 200, res2
        ref2 = jax_engine.run_script("Loopback", params(True)[0], loop)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    for r, response in ((ref, res), (ref2, res2)):
        decoded = [decode_png(base64.b64decode(b)) for b in response["images"]]
        assert len(decoded) == len(r.images)
        for (img, text), ref_img, ref_text in zip(decoded, as_arrays(r.images), r.infotexts):
            assert np.abs(img.astype(int) - ref_img.astype(int)).max() <= 1
            assert text["parameters"] == ref_text
        assert json.loads(response["info"])["infotexts"] == r.infotexts


REFUSALS = [
    # 400: JAX's answers (api.py:240-250, 1479-1483)
    ("txt2img", dict(script_name="No such script"), 400, "Script not found"),
    ("txt2img", dict(script_name="postprocessing (main UI)"), 400, "always-on"),
    ("txt2img", dict(script_name="Custom code", script_args=["x = 1"]), 400, "--allow-code"),
    ("img2img", dict(script_name="Loopback", script_args=["four"]), 400, "(Loops)"),
    ("txt2img", dict(script_name="X/Y/Z plot", script_args=["Steps", "2, many"]), 400,
     "X values"),
    # 422: what the port does not draw (a legend in Pillow's default font at
    # a size other than 10, which JAX falls back to when the font option
    # names a file that cannot be opened; "options": the server's options
    # while the request runs), and what JAX's script path ignores
    ("txt2img", dict(script_name="X/Y/Z plot", script_args=["Seed", "1-2"],
                     options={"font": "/no/such/font.ttf"}), 422, "TrueType font"),
    ("txt2img", dict(script_name="Prompt matrix", prompt="a|b",
                     options={"font": "/no/such/font.ttf"}), 422, "TrueType font"),
    ("txt2img", dict(script_name="X/Y/Z plot",
                     script_args=["Emphasis", "Original, No norm", "Nothing", "", "Nothing", "",
                                  False]), 422, "'Emphasis'"),
    ("txt2img", dict(script_name="X/Y/Z plot", styles=["a"],
                     script_args=["Seed", "1-2", "Nothing", "", "Nothing", "", False]), 422,
     "styles"),
    ("txt2img", dict(script_name="X/Y/Z plot", override_settings={"sd_vae": "None"},
                     script_args=["Seed", "1-2", "Nothing", "", "Nothing", "", False]), 422,
     "sd_vae"),
    ("txt2img", dict(script_name="Prompts from file or textbox",
                     script_args=[False, True, "a cat"]), 422, "Use same random seed"),
    ("txt2img", dict(alwayson_scripts={"adetailer": {"args": []}}), 422, "adetailer"),
    ("txt2img", dict(postprocessing={"enable": ["Upscale"], "upscale_first": True,
                                     "sharpen": 1}), 422, "sharpen"),
    ("txt2img", dict(postprocessing={"enable": ["Sharpen"]}), 422, "Sharpen"),
    ("txt2img", dict(postprocessing={"enable": ["Upscale"], "upscaler_1": "Nope"}), 422,
     "Nope"),
    ("txt2img", dict(script_name="X/Y/Z plot", script_args="Seed"), 422, "script_args"),
]


@pytest.mark.parametrize("route,body,status,detail", REFUSALS)
def test_refusals_name_what_they_refuse(engines, route, body, status, detail):
    api = Api(engines[1])
    request = dict(BASE, **{k: v for k, v in body.items() if k != "options"})
    if route == "img2img":
        request["init_images"] = [_b64(_init_image())]
    with opts.override(body.get("options", {})):
        code, res = api.handle("POST", f"/sdapi/v1/{route}", request)
    assert (code, detail in res["detail"]) == (status, True), res
