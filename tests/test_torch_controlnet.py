"""ControlNet in the port against the JAX package (CPU, f32): the tower's
residuals (SD1.5 and SDXL tiny configs), ``convert_controlnet`` on the
cldm, bare and diffusers layouts, the UNet's cldm-form ``control=`` against
a composition of JAX's own block functions (and where JAX's form differs
import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
from it), the canny / threshold annotators against cv2 in every pixel, and
whole txt2img / hires / img2img requests with units through both packages.
Inputs are made with numpy from a seed; tolerances are stated per test."""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.loader.convert import convert_controlnet as jax_convert_controlnet
from sdwebui_tpu.models import controlnet as jax_cn
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.models.layers import conv2d, group_norm_p, linear, silu, timestep_embedding
from sdwebui_tpu.pipeline import control as jax_control
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu.utils.pytree import flatten
from sdwebui_tpu_torch.loader import convert as port_convert
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.models.controlnet import ControlNetModel
from sdwebui_tpu_torch.networks import NetworkNotFound
from sdwebui_tpu_torch.pipeline import annotators
from sdwebui_tpu_torch.pipeline import control as port_control
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_models import _assert_rel, _nchw, _nhwc, _perturbed

TINY = port_sd.TINY_UNET


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_policies():
    jax_prev, port_prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    yield
    jax_devices.set_policy(jax_prev)
    port_devices.set_policy(port_prev)


def _tower_params(cfg, seed, zero_input_convs=False, out_scale=1.0):
    """A JAX tower with every weight random (non-zero zero-convs and hint
    output), biases perturbed; the zero-convs scaled by out_scale (a trained
    tower's residuals are small beside the UNet's activations, a random
    one's are not); optionally its input zero-convs zeroed, so that only
    the middle residual is non-zero."""
    params = jax_cn.init_params(cfg, seed, dtype=jnp.float32, zero_init=False)
    params = _perturbed(params, np.random.default_rng(seed))
    convs = {**{f"z{i}": zc for i, zc in params["zero_convs"].items()},
             "mid": params["middle_block_out"]}
    for name, zc in convs.items():
        scale = 0.0 if zero_input_convs and name != "mid" else out_scale
        zc["0"] = {k: np.asarray(v) * np.float32(scale) for k, v in zc["0"].items()}
    return params


def _port_tower(params, cfg):
    tower = ControlNetModel(cfg, device="cpu", dtype=torch.float32)
    tower.load_state_dict(port_sd.state_dict_from_tree(params), strict=True)
    return tower


def _inputs(cfg, b=2, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 4), dtype=np.float32)
    t = np.asarray([700.0, 12.5][:b], np.float32)
    ctx = rng.standard_normal((b, 77, cfg.context_dim), dtype=np.float32)
    hint = rng.random((b, hw * 8, hw * 8, 3), dtype=np.float32)
    y = rng.standard_normal((b, cfg.adm_in_channels), dtype=np.float32) \
        if cfg.adm_in_channels else None
    return x, t, ctx, hint, y


def _jax_residuals(params, cfg, x, t, ctx, hint, y):
    apply = jax.jit(lambda p, *a, y=None: jax_cn.apply(p, cfg, *a, y=y))
    res = apply(params, *(jnp.asarray(a) for a in (x, t, ctx, hint)),
                y=None if y is None else jnp.asarray(y))
    return [np.asarray(r) for r in res["input"]] + [np.asarray(res["middle"])]


def _port_residuals(tower, x, t, ctx, hint, y):
    with torch.inference_mode():
        res = tower(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), _nchw(hint),
                    None if y is None else torch.from_numpy(y))
    return [_nhwc(r) for r in res["input"]] + [_nhwc(res["middle"])]


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_tower_matches_jax(family):
    """Every input residual and the middle one within 1e-4 of the largest
    magnitude of JAX's ``controlnet.apply`` (f32)."""
    cfg = TINY if family == "sd15" else port_sd.TINY_SDXL_UNET
    params = _tower_params(cfg, 3)
    args = _inputs(cfg)
    ref = _jax_residuals(params, cfg, *args)
    out = _port_residuals(_port_tower(params, cfg), *args)
    assert len(out) == len(ref) == len(jax_unet.build_plan(cfg)[0]) + 1
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        _assert_rel(o, r, 1e-4)


def _to_diffusers(cldm: dict, n_res: int) -> dict:
    """The diffusers names of a cldm-layout tower state dict."""
    inv = {"in_layers.0": "norm1", "in_layers.2": "conv1", "emb_layers.1": "time_emb_proj",
           "out_layers.0": "norm2", "out_layers.3": "conv2", "skip_connection": "conv_shortcut"}
    out = {}
    for k, v in cldm.items():
        parts = k.split(".")
        tail = parts[-1]
        if k.startswith("time_embed."):
            out[f"time_embedding.linear_{1 if parts[1] == '0' else 2}.{tail}"] = v
        elif k.startswith("input_blocks.0.0."):
            out["conv_in." + tail] = v
        elif k.startswith("middle_block_out.0."):
            out["controlnet_mid_block." + tail] = v
        elif k.startswith("zero_convs."):
            out[f"controlnet_down_blocks.{parts[1]}.{tail}"] = v
        elif k.startswith("input_hint_block."):
            j = int(parts[1])
            name = "conv_in" if j == 0 else "conv_out" if j == 14 else f"blocks.{(j - 2) // 2}"
            out[f"controlnet_cond_embedding.{name}.{tail}"] = v
        elif k.startswith("middle_block."):
            slot, rest = int(parts[1]), ".".join(parts[2:])
            if slot == 1:
                out["mid_block.attentions.0." + rest] = v
            else:
                name, t = rest.rsplit(".", 1)
                out[f"mid_block.resnets.{slot // 2}.{inv[name]}.{t}"] = v
        else:
            idx, slot, rest = int(parts[1]), int(parts[2]), ".".join(parts[3:])
            level, off = (idx - 1) // (n_res + 1), (idx - 1) % (n_res + 1)
            if rest.startswith("op."):
                out[f"down_blocks.{level}.downsamplers.0.conv." + rest[3:]] = v
            elif slot == 1:
                out[f"down_blocks.{level}.attentions.{off}." + rest] = v
            else:
                name, t = rest.rsplit(".", 1)
                out[f"down_blocks.{level}.resnets.{off}.{inv[name]}.{t}"] = v
    return out


@pytest.mark.parametrize("layout", ["control_model", "bare", "diffusers"])
def test_convert_controlnet_layouts(layout):
    """Each layout gives JAX's config and hint channels, the names of the
    JAX tree, and a tower whose residuals are JAX's (1e-4)."""
    params = _tower_params(TINY, 5)
    cldm = port_sd.state_dict_from_tree(params)
    sd = {"control_model." + k: v for k, v in cldm.items()} if layout == "control_model" \
        else cldm if layout == "bare" else _to_diffusers(cldm, TINY.num_res_blocks)
    if layout == "control_model":     # a full checkpoint holds the UNet too
        sd["model.diffusion_model.out.2.weight"] = torch.zeros(4, 32, 3, 3)
    ref_tree, ref_cfg, ref_hint = jax_convert_controlnet({k: v.numpy() for k, v in sd.items()})
    flat, cfg, hint = port_convert.convert_controlnet(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg) and hint == ref_hint == 3
    assert set(flat) == set(flatten(ref_tree)) == set(cldm)
    tower = ControlNetModel(cfg, hint_channels=hint, device="cpu", dtype=torch.float32)
    tower.load_state_dict(flat, strict=True)
    args = _inputs(cfg, seed=1)
    for o, r in zip(_port_residuals(tower, *args), _jax_residuals(params, TINY, *args)):
        _assert_rel(o, r, 1e-4)


# --------------------------------------------------------------------------
# the control injection: cldm's form, not JAX's
# --------------------------------------------------------------------------

def _cldm_unet(params, cfg, x, t, ctx, control):
    """lllyasviel's ControlledUnetModel composed from JAX's own block
    functions: the encoder without control, the middle residual after the
    middle block, each input residual on its skip at the decoder."""
    input_plan, _, output_plan, _ = jax_unet.build_plan(cfg)
    emb = linear(params["time_embed"]["2"],
                 silu(linear(params["time_embed"]["0"], timestep_embedding(t, cfg.model_channels))))
    hs, h = [], x
    for i, plan in enumerate(input_plan):
        h = jax_unet._apply_layers(plan, params["input_blocks"][str(i)], h, emb, ctx, cfg)
        hs.append(h)
    mp = params["middle_block"]
    h = jax_unet._resblock(mp["0"], h, emb)
    h = jax_unet._spatial_transformer(mp["1"], h, ctx, cfg, len(mp["1"]["transformer_blocks"]))
    h = jax_unet._resblock(mp["2"], h, emb)
    h = h + control["middle"]
    for i, plan in enumerate(output_plan):
        skip = hs.pop() + control["input"][len(hs)]
        h = jax_unet._apply_layers(plan, params["output_blocks"][str(i)],
                                   jnp.concatenate([h, skip], axis=-1), emb, ctx, cfg)
    h = group_norm_p(params["out"]["0"], h, silu=True)
    return conv2d(params["out"]["2"], h)


@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(13)
    rng = np.random.default_rng(130)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng),
                             vae_params=_perturbed(jm.vae_params, rng))
    jm.conditioner.params = _perturbed(jm.conditioner.params, rng)
    return jm, port_sd.from_jax(jm, device="cpu")


def test_control_injection_is_cldms(models):
    """The port's ``unet(control=)`` against the cldm composition of JAX's
    block functions (1e-4).  JAX's ``unet.apply(control=)`` equals that
    composition exactly when only the middle residual is non-zero, and
    differs from it once input residual 0 is non-zero: it adds input
    residuals inside the encoder (sdwebui_tpu/models/unet.py:318-323)."""
    jm, pm = models
    cfg = jm.unet_cfg
    x, t, ctx, _, _ = _inputs(cfg, hw=8, seed=2)
    shapes = jax_cn.residual_shapes(cfg, 2, 8, 8)
    rng = np.random.default_rng(20)
    control = {"input": tuple(rng.standard_normal(s).astype(np.float32) for s in shapes["input"]),
               "middle": rng.standard_normal(shapes["middle"]).astype(np.float32)}
    jc = {k: (tuple(map(jnp.asarray, v)) if k == "input" else jnp.asarray(v))
          for k, v in control.items()}
    ref = np.asarray(jax.jit(lambda p, *a: _cldm_unet(p, cfg, *a))(
        jm.unet_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jc))
    with torch.inference_mode():
        out = pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                      control={"input": tuple(_nchw(r) for r in control["input"]),
                               "middle": _nchw(control["middle"])})
    _assert_rel(_nhwc(out), ref, 1e-4)

    middle_only = dict(jc, input=tuple(jnp.zeros_like(r) for r in jc["input"]))
    a = np.asarray(jax_unet.apply(jm.unet_params, cfg, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx), control=middle_only))
    b = np.asarray(_cldm_unet(jm.unet_params, cfg, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ctx), middle_only))
    np.testing.assert_array_equal(a, b)
    first = dict(middle_only, input=(jc["input"][0],) + middle_only["input"][1:])
    a = np.asarray(jax.jit(lambda p, *a: jax_unet.apply(p, cfg, *a[:3], control=a[3]))(
        jm.unet_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), first))
    b = np.asarray(jax.jit(lambda p, *a: _cldm_unet(p, cfg, *a))(
        jm.unet_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), first))
    assert np.abs(a - b).max() > 1e-2 * np.abs(b).max()


# --------------------------------------------------------------------------
# annotators against cv2
# --------------------------------------------------------------------------

def _grid(h, w, cell=16):
    yy, xx = np.mgrid[:h, :w]
    img = np.zeros((h, w, 3), np.uint8)
    img[((yy // cell) + (xx // cell)) % 2 == 0] = 255
    return img


def _images():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
        "flat": np.full((20, 31, 3), 77, np.uint8),
        "gradient": np.broadcast_to((np.arange(61) * 4)[None, :, None], (29, 61, 3)).astype(
            np.uint8).copy(),
        "grid16": _grid(64, 80),
        "blurred": cv2.GaussianBlur(rng.integers(0, 256, (71, 45, 3), dtype=np.uint8), (0, 0), 2),
    }


@pytest.mark.parametrize("image", list(_images()))
@pytest.mark.parametrize("thresholds", [(100, 200), (0, 255), (50, 50)])
def test_canny_equals_cv2(image, thresholds):
    img = _images()[image]
    np.testing.assert_array_equal(annotators.canny(img, 0, *thresholds),
                                  cv2.Canny(img, *thresholds))


@pytest.mark.parametrize("image", list(_images()))
def test_threshold_and_invert_equal_cv2(image):
    img = _images()[image]
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    for thr in (0, 100, 127, 254):
        np.testing.assert_array_equal(annotators.threshold(img, 0, thr),
                                      cv2.threshold(gray, thr, 255, cv2.THRESH_BINARY)[1])
    np.testing.assert_array_equal(annotators.invert(img), 255 - img)


def test_annotator_dispatch():
    img = _grid(64, 64)
    np.testing.assert_array_equal(annotators.run_annotator("canny", img, res=64),
                                  cv2.Canny(img, 100, 200))
    np.testing.assert_array_equal(
        annotators.run_annotator("canny", img.astype(np.float32) / 255, res=0,
                                 threshold_a=50, threshold_b=60), cv2.Canny(img, 50, 60))
    np.testing.assert_array_equal(
        annotators.run_annotator("canny", img, res=32),
        cv2.Canny(cv2.resize(img, (32, 32), interpolation=cv2.INTER_AREA), 100, 200))
    np.testing.assert_array_equal(
        annotators.run_annotator("canny", img, res=512),
        cv2.Canny(cv2.resize(img, (512, 512), interpolation=cv2.INTER_LANCZOS4), 100, 200))
    with pytest.raises(RuntimeError, match="body_pose"):    # ported: its weights are absent
        annotators.run_annotator("openpose", img, device="cpu")
    with pytest.raises(NetworkNotFound, match="nope"):
        annotators.run_annotator("nope", img)
    assert annotators.list_modules()[:3] == ["none", "canny", "invert"]


# --------------------------------------------------------------------------
# whole requests
# --------------------------------------------------------------------------

@pytest.fixture
def tower_dir(tmp_path):
    """Two tiny towers, registered in both packages: "full" (every weight
    random) and "midonly" (input zero-convs zero, so that the two injection
    forms agree)."""
    for name, zero in (("full", False), ("midonly", True)):
        sd = port_sd.state_dict_from_tree(_tower_params(TINY, 9, zero_input_convs=zero,
                                                        out_scale=0.1))
        write_safetensors(str(tmp_path / f"{name}.safetensors"),
                          {"control_model." + k: v for k, v in sd.items()})
    jax_control.set_model_dirs([str(tmp_path)])
    port_control.set_model_dirs([str(tmp_path)])
    yield tmp_path
    jax_control.set_model_dirs(["models/ControlNet"])
    port_control.set_model_dirs([port_control.DEFAULT_CONTROLNET_DIR])


def _hint(seed=4, size=64):
    return _grid(size, size) if seed is None else np.kron(
        np.random.default_rng(seed).integers(0, 256, (size // 8, size // 8, 3)).astype(np.uint8),
        np.ones((8, 8, 1), np.uint8))


def _params(**kw):
    base = dict(prompt="a cat AND a dog :0.6", negative_prompt="blurry", seed=31, steps=4,
                width=64, height=64, batch_size=2, cfg_scale=7.5, sampler_name="Euler",
                override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return GenerationParams(**base)


def _assert_same(out, ref):
    ref_imgs = [np.asarray(im) for im in ref.images[ref.index_of_first_image:]]
    out_imgs = out.images[out.index_of_first_image:]
    assert len(out_imgs) == len(ref_imgs)
    for a, b in zip(out_imgs, ref_imgs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts[out.index_of_first_image:] == \
        ref.infotexts[ref.index_of_first_image:]


UNIT_CASES = {
    "balanced": [dict(control_mode=0, weight=1.5)],
    "prompt_more_important": [dict(control_mode="My prompt is more important", weight=2.0)],
    "controlnet_more_important": [dict(control_mode=2, weight=2.0)],
    "guidance_range": [dict(guidance_start=0.3, guidance_end=0.7, weight=2.0)],
    "canny_and_second_unit": [dict(module="canny", image_seed=None, weight=1.2),
                              dict(control_mode=1, weight=0.8, guidance_end=0.5)],
}


def _units(case, image_fn=lambda a: a):
    units = []
    for u in UNIT_CASES[case]:
        u = dict(u)
        seed = u.pop("image_seed", 4)
        units.append(dict(model="midonly", image=image_fn(_hint(seed)), **u))
    return units


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_txt2img_with_units_matches_jax(models, f32_policies, tower_dir, case):
    """Control modes 0-2 (mode 2 on the cond rows of an AND prompt),
    a guidance range and two units (one through the canny annotator) on a
    tower whose input zero-convs are zero: within 1 uint8 level of JAX's
    ``process_txt2img``, identical infotext, and unlike the run without
    units."""
    jm, pm = models
    ref = jax_proc.process_txt2img(jm, _params(controlnet_units=_units(case)))
    out = port_proc.process_txt2img(pm, _params(controlnet_units=_units(case)))
    _assert_same(out, ref)
    plain = port_proc.process_txt2img(pm, _params())
    assert not np.array_equal(out.images[-1], plain.images[-1])


def test_hires_with_unit_matches_jax(models, f32_policies, tower_dir):
    """txt2img with hires fix (64² → 128², "Latent"): the unit's image is
    re-prepared at the target size (Pillow's LANCZOS in JAX, the port's
    restatement), the second pass gated over t_enc + 1 steps."""
    jm, pm = models
    kw = dict(enable_hr=True, hr_scale=2.0, hr_upscaler="Latent", denoising_strength=0.6,
              batch_size=1, prompt="a cat")
    ref = jax_proc.process_txt2img(jm, _params(
        controlnet_units=_units("guidance_range", Image.fromarray), **kw))
    out = port_proc.process_txt2img(pm, _params(controlnet_units=_units("guidance_range"), **kw))
    _assert_same(out, ref)


@pytest.fixture
def pose_dir(tmp_path_factory):
    """A seeded body_pose_model.pth found by both packages' annotators
    (its maps scaled to hold peaks: test_torch_openpose), cv2's own resize
    code (its IPP float resize moves JAX's peaks)."""
    from sdwebui_tpu.pipeline import annotators as jax_ann
    from test_torch_openpose import _state_dict

    d = tmp_path_factory.mktemp("Annotators")
    torch.save(_state_dict(), d / "body_pose_model.pth")
    prev_jax, prev = list(jax_ann._model_dirs), list(annotators._model_dirs)
    jax_ann._model_dirs[:] = [str(d)]
    jax_ann._loaded.clear()
    annotators.set_annotator_dirs([str(d)])
    cv2.ipp.setUseIPP(False)
    yield d
    cv2.ipp.setUseIPP(True)
    jax_ann._model_dirs[:] = prev_jax
    jax_ann._loaded.clear()
    annotators.set_annotator_dirs(prev)


def test_openpose_unit_matches_jax(models, f32_policies, tower_dir, pose_dir):
    """A unit with the openpose module (the request's image, processor_res
    64) within 1 uint8 level of JAX's, identical infotext (img2img reaches
    the same unit code: test_img2img_unit_takes_the_init_image)."""
    jm, pm = models
    photo = cv2.GaussianBlur(np.random.default_rng(3).integers(0, 256, (64, 64, 3),
                                                               dtype=np.uint8), (0, 0), 6)
    unit = dict(model="midonly", image=photo, module="openpose", weight=2.0,
                processor_res=64)
    kw = dict(steps=3, batch_size=1, controlnet_units=[unit])
    ref = jax_proc.process_txt2img(jm, _params(**kw))
    out = port_proc.process_txt2img(pm, _params(**kw))
    _assert_same(out, ref)
    hint = annotators.run_annotator("openpose", photo, res=64, device="cpu")
    assert (hint > 0).any()


def test_img2img_unit_takes_the_init_image(models, f32_policies, tower_dir):
    """A unit without an image of its own takes img2img's init image."""
    jm, pm = models
    init = _hint(11)
    kw = dict(init_images=[init], denoising_strength=0.75, steps=5, batch_size=1,
              prompt="a cat", controlnet_units=[dict(model="midonly", weight=2.0)])
    ref = jax_i2i.process_img2img(jm, _params(**kw))
    out = port_i2i.process_img2img(pm, _params(**kw))
    _assert_same(out, ref)
    with_image = port_i2i.process_img2img(pm, _params(**dict(kw, controlnet_units=[
        dict(model="midonly", weight=2.0, image=_hint(12))])))
    assert not np.array_equal(out.images[0], with_image.images[0])


def test_tower_runs_only_at_active_steps(models, tower_dir, monkeypatch):
    """The guidance range gates on the host: the tower runs at the 5 of 10
    Euler steps with i / 9 <= 0.5, and at none with weight 0."""
    _, pm = models
    calls = []
    real = ControlNetModel.forward
    monkeypatch.setattr(ControlNetModel, "forward",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    unit = dict(model="full", image=_hint(), guidance_end=0.5)
    port_proc.process_txt2img(pm, _params(steps=10, batch_size=1, controlnet_units=[unit]))
    assert len(calls) == 5
    calls.clear()
    port_proc.process_txt2img(pm, _params(steps=3, batch_size=1,
                                          controlnet_units=[dict(unit, weight=0.0)]))
    assert not calls


def test_unit_errors(models, tower_dir):
    _, pm = models
    with pytest.raises(NetworkNotFound, match="missing"):
        port_proc.process_txt2img(pm, _params(steps=1, controlnet_units=[
            dict(model="missing", image=_hint())]))
    with pytest.raises(RuntimeError, match="body_pose"):    # ported: its weights are absent
        port_proc.process_txt2img(pm, _params(steps=1, controlnet_units=[
            dict(model="full", image=_hint(), module="openpose")]))
    with pytest.raises(ValueError, match="control_mode"):
        port_proc.process_txt2img(pm, _params(steps=1, controlnet_units=[
            dict(model="full", image=_hint(), control_mode="sideways")]))
    assert port_control.list_models() == ["full", "midonly"]


def test_controlnet_routes(tower_dir):
    """The extension's routes, units over /sdapi/v1/txt2img as
    ``controlnet_units`` and as ``alwayson_scripts``, and the 4xx answers."""
    import base64

    from sdwebui_tpu_torch.server.api import Api
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    api = Api(Engine(device="cpu", tiny=True, embeddings_dir=str(tower_dir)))
    assert api.handle("GET", "/controlnet/model_list", None) == (
        200, {"model_list": ["full", "midonly"]})
    assert api.handle("GET", "/controlnet/version", None) == (200, {"version": 2})
    status, mods = api.handle("GET", "/controlnet/module_list", None)
    assert status == 200 and "canny" in mods["module_list"]
    grid = _grid(64, 64)
    b64 = base64.b64encode(encode_png(grid)).decode()
    status, out = api.handle("POST", "/controlnet/detect", {
        "controlnet_module": "canny", "controlnet_input_images": [b64],
        "controlnet_processor_res": 64, "controlnet_threshold_a": 50,
        "controlnet_threshold_b": 150})
    assert status == 200
    np.testing.assert_array_equal(decode_png(base64.b64decode(out["images"][0]))[0][:, :, 0],
                                  cv2.Canny(grid, 50, 150))
    status, out = api.handle("POST", "/controlnet/detect", {
        "controlnet_module": "canny", "controlnet_input_images": [b64]})
    assert status == 200     # processor_res 512: the LANCZOS4 upscale, then canny
    np.testing.assert_array_equal(
        decode_png(base64.b64decode(out["images"][0]))[0][:, :, 0],
        cv2.Canny(cv2.resize(grid, (512, 512), interpolation=cv2.INTER_LANCZOS4), 100, 200))
    base = {"steps": 2, "width": 64, "height": 64, "batch_size": 1, "seed": 5}
    unit = {"model": "midonly", "image": b64, "weight": 2.0, "module": "canny"}
    a = api.handle("POST", "/sdapi/v1/txt2img", dict(base, controlnet_units=[unit]))
    b = api.handle("POST", "/sdapi/v1/txt2img", dict(base, alwayson_scripts={
        "controlnet": {"args": [dict(unit, input_image=unit["image"], image=None,
                                     pixel_perfect=False)]}}))
    assert a[0] == b[0] == 200 and a[1]["images"] == b[1]["images"]
    for body, status_want, words in (
            (dict(base, controlnet_units=[dict(unit, model="gone")]), 404, "gone"),
            (dict(base, controlnet_units=[dict(unit, module="nope")]), 404, "nope"),
            (dict(base, controlnet_units=[dict(unit, pixel_perfect=True)]), 422, "pixel_perfect"),
            (dict(base, alwayson_scripts={"adetailer": {"args": []}}), 422, "adetailer")):
        status, out = api.handle("POST", "/sdapi/v1/txt2img", body)
        assert status == status_want and words in out["detail"], out
