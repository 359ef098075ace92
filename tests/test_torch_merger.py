"""The port's checkpoint merger (``postprocessing/merger.py``) against the
JAX package's: every branch of ``merge_checkpoints`` bit-equal to JAX's
numpy merge on seeded state dicts, ``run_modelmerger``'s file equal to
JAX's and generating through the port's loader as the in-memory merge
does, the identity merges, and ``/sdapi/v1/modelmerger`` (a traversing
``custom_name`` answers 400)."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from sdwebui_tpu.loader import safetensors_io as jax_st
from sdwebui_tpu.postprocessing import merger as jax_merger
from sdwebui_tpu_torch.loader import load
from sdwebui_tpu_torch.loader.safetensors_io import (read_metadata, read_state_dict,
                                                     write_safetensors)
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.pipeline.processing import process_txt2img
from sdwebui_tpu_torch.pipeline.sd_model import create_tiny_sd
from sdwebui_tpu_torch.postprocessing import merger

UNET = "model.diffusion_model."


def _dicts(seed: int = 0):
    """(primary, secondary, tertiary) numpy state dicts over every branch:
    same-shape floats of each dtype, a 9- against 4-channel conv_in and the
    reverse, a 2-D shape mismatch (kept), model_ema keys, integer tensors,
    keys only in the primary or missing from the tertiary."""
    rng = np.random.default_rng(seed)

    def f(*shape, dtype=np.float32):
        return rng.standard_normal(shape).astype(dtype)

    def sd(conv_in_ch, other_ch, extra: bool):
        d = {f"{UNET}w": f(64, 33), f"{UNET}h": f(40, dtype=np.float16),
             f"{UNET}b": f(17, 5).astype(ml_dtypes.bfloat16), f"{UNET}d": f(9, dtype=np.float64),
             f"{UNET}input_blocks.0.0.weight": f(8, conv_in_ch, 3, 3),
             f"{UNET}other_conv.weight": f(8, other_ch, 3, 3),
             f"{UNET}mismatch": f(6, 4 if extra else 5),
             "model_ema.decay": f(3), "model_ema.w": f(64, 33),
             "cond_stage_model.position_ids": np.arange(77)[None] * (1 + int(extra)),
             "first_stage_model.z": f(5, 7)}
        if extra:
            d["only.primary"] = f(4)
        return d

    primary = sd(9, 4, True)
    secondary = sd(4, 9, False)
    tertiary = sd(4, 9, False)
    del tertiary[f"{UNET}w"]       # JAX's c = 0 for a key the tertiary lacks
    return primary, secondary, tertiary


def _torch(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if v.dtype == np.dtype(ml_dtypes.bfloat16):
            out[k] = torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v).copy())
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _assert_bit_equal(port: dict, jax: dict):
    assert list(port) == list(jax)
    for k, want in jax.items():
        got = _numpy(port[k])
        want = np.asarray(want)
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        assert got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k


@pytest.mark.parametrize("method", ["Weighted sum", "Add difference", "No interpolation"])
@pytest.mark.parametrize("multiplier", [0.0, 0.3, 0.5, 0.77, 1.0, 1.7])
@pytest.mark.parametrize("save_as_half", [False, True])
def test_merge_branches_bit_equal_jax(method, multiplier, save_as_half):
    a, b, c = _dicts()
    want = jax_merger.merge_checkpoints(a, b, c, method, multiplier, save_as_half)
    got = merger.merge_checkpoints(_torch(a), _torch(b), _torch(c), method, multiplier,
                                   save_as_half, device="cpu")
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("save_as_half", [False, True])
def test_vae_bake_and_discard_equal_jax(save_as_half):
    a, b, _ = _dicts(1)
    a["only.bf16"] = np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)
    vae = {"decoder.x": np.full((2, 3), 5.0, np.float32), "z": np.ones(3, np.float16)}
    pattern = r"model_ema|\.mismatch$"
    want = jax_merger.merge_checkpoints(a, b, None, "Weighted sum", 0.25, save_as_half, vae,
                                        pattern)
    got = merger.merge_checkpoints(_torch(a), _torch(b), None, "Weighted sum", 0.25,
                                   save_as_half, _torch(vae), pattern, device="cpu")
    _assert_bit_equal(got, want)
    assert "model_ema.decay" not in got and "first_stage_model.decoder.x" in got
    # an unmerged bfloat16 tensor stays bfloat16 under save_as_half: numpy's
    # `floating` excludes it
    assert got["only.bf16"].dtype == torch.bfloat16


def test_primary_tensors_are_not_written():
    a, b, _ = _dicts(2)
    ta = _torch(a)
    before = {k: v.clone() for k, v in ta.items()}
    merger.merge_checkpoints(ta, _torch(b), None, "Weighted sum", 0.5, device="cpu")
    assert all(torch.equal(before[k], ta[k]) for k in ta)


def test_add_difference_needs_a_tertiary_and_methods_are_named():
    a, b, _ = _dicts()
    with pytest.raises(ValueError):
        jax_merger.merge_checkpoints(a, b, None, method="Add difference")
    with pytest.raises(ValueError):
        merger.merge_checkpoints(_torch(a), _torch(b), None, method="Add difference")
    with pytest.raises(NotImplementedError, match="Train difference"):
        merger.merge_checkpoints(_torch(a), _torch(b), None, method="Train difference")


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card")
def test_merge_defaults_to_the_card():
    """With no device the merge runs on the card: without one it raises,
    and never merges on the host unasked."""
    a, b, _ = _dicts()
    with pytest.raises(RuntimeError, match="cuda"):
        merger.merge_checkpoints(_torch(a), _torch(b), None, "Weighted sum", 0.5)


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """Two tiny SD1.5 checkpoints (seeds 0 and 1) as ldm-layout files."""
    d = tmp_path_factory.mktemp("merge")
    paths = []
    for seed in (0, 1):
        path = str(d / f"tiny{seed}.safetensors")
        write_safetensors(path, load.ldm_state_dict(create_tiny_sd(seed, "cpu")))
        paths.append(path)
    return d, paths


def _image(model):
    p = GenerationParams(prompt="a red cat", negative_prompt="blurry", seed=5, steps=2,
                         width=64, height=64, sampler_name="Euler")
    return process_txt2img(model, p).images[0]


def test_run_modelmerger_file_equals_jax_and_generates(tiny_files):
    d, (first, second) = tiny_files
    out = merger.run_modelmerger(first, second, None, "Weighted sum", 0.4, True, "port-ws",
                                 output_dir=str(d), device="cpu")
    theirs = jax_merger.run_modelmerger(first, second, None, "Weighted sum", 0.4, True,
                                        "jax-ws", output_dir=str(d))
    assert out == os.path.join(str(d), "port-ws.safetensors")
    assert read_metadata(out) == read_metadata(theirs) == {
        "sd_merge_recipe": "Weighted sum 0.4 tiny0.safetensors + tiny1.safetensors",
        "format": "pt"}
    _assert_bit_equal(read_state_dict(out), jax_st.read_state_dict(theirs))
    # the file loads through the port's loader and generates what a model
    # built from the in-memory merge generates
    in_memory = merger.merge_checkpoints(load.read_checkpoint(first),
                                         load.read_checkpoint(second), None,
                                         "Weighted sum", 0.4, True, device="cpu")
    from_file = _image(load.load_model(out, device="cpu"))
    np.testing.assert_array_equal(from_file,
                                  _image(load.model_from_state_dict(in_memory, device="cpu")))
    assert not np.array_equal(from_file, _image(load.load_model(first, device="cpu")))


def test_identity_merges_give_the_primary(tiny_files):
    d, (first, second) = tiny_files
    primary = load.read_checkpoint(first)
    for method, tertiary, name in (("Weighted sum", None, "ws0"),
                                   ("Add difference", second, "ad")):
        out = merger.run_modelmerger(first, second, tertiary, method,
                                     0.0 if method == "Weighted sum" else 0.7, False, name,
                                     output_dir=str(d), device="cpu")
        merged = read_state_dict(out)
        assert list(merged) == list(primary)
        for k, v in primary.items():
            assert merged[k].dtype == torch.float32, k
            assert torch.equal(merged[k], v.float()), k


def test_modelmerger_route(tiny_files, tmp_path):
    from sdwebui_tpu_torch.server.api import Api
    from sdwebui_tpu_torch.server.app import Engine

    _, (first, second) = tiny_files
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    for path in (first, second):
        os.link(path, ckpts / os.path.basename(path))
    engine = Engine(device="cpu", ckpt_dirs=[str(ckpts)], hash_cache=str(tmp_path / "h.json"))
    api = Api(engine)
    status, out = api.handle("POST", "/sdapi/v1/modelmerger", {
        "primary_model": "tiny0", "secondary_model": "tiny1.safetensors",
        "interp_method": "Weighted sum", "multiplier": 0.5, "save_as_half": True,
        "custom_name": "mixed"})
    target = str(ckpts / "mixed.safetensors")
    assert status == 200 and out == {"info": f"merged checkpoint saved to {target}"}
    want = jax_merger.merge_checkpoints(jax_st.read_state_dict(first),
                                        jax_st.read_state_dict(second), None,
                                        "Weighted sum", 0.5, True)
    _assert_bit_equal(read_state_dict(target), want)
    names = [m["model_name"] for m in api.handle("GET", "/sdapi/v1/sd-models", None)[1]]
    assert "mixed" in names
    status, res = api.handle("POST", "/sdapi/v1/txt2img", {
        "steps": 1, "width": 64, "height": 64,
        "override_settings": {"sd_model_checkpoint": "mixed"}})
    assert status == 200, res
    # the page's merger form sends titles, and a VAE file bakes in
    titles = {m["model_name"]: m["title"] for m in api.handle("GET", "/sdapi/v1/sd-models",
                                                              None)[1]}
    vae = tmp_path / "vae.safetensors"
    write_safetensors(str(vae), {"decoder.conv_in.bias": torch.arange(4.0)})
    status, out = api.handle("POST", "/sdapi/v1/modelmerger", {
        "primary_model": titles["tiny0"], "secondary_model": titles["tiny1"],
        "interp_method": "No interpolation", "custom_name": "baked", "bake_in_vae": str(vae),
        "discard_weights": "model_ema"})
    assert status == 200, out
    baked = read_state_dict(str(ckpts / "baked.safetensors"))
    assert torch.equal(baked["first_stage_model.decoder.conv_in.bias"], torch.arange(4.0))
    assert api.handle("POST", "/sdapi/v1/modelmerger", {
        "primary_model": "tiny0", "bake_in_vae": "no-such-vae"})[0] == 404
    os.remove(vae)
    for bad in ("../evil", "a/b", "a\\b", "..", "sub/../../x"):
        status, res = api.handle("POST", "/sdapi/v1/modelmerger", {
            "primary_model": "tiny0", "secondary_model": "tiny1", "custom_name": bad})
        assert status == 400 and "invalid merged checkpoint name" in res["detail"], bad
    assert sorted(os.listdir(tmp_path)) == ["ckpts", "h.json"]
    assert sorted(os.listdir(ckpts)) == ["baked.safetensors", "mixed.safetensors",
                                         "tiny0.safetensors", "tiny1.safetensors"]
    status, res = api.handle("POST", "/sdapi/v1/modelmerger", {
        "primary_model": "tiny0", "secondary_model": "tiny1", "interp_method": "Add difference"})
    assert status == 400 and "tertiary" in res["detail"]
    status, res = api.handle("POST", "/sdapi/v1/modelmerger", {
        "primary_model": "nope", "secondary_model": "tiny1"})
    assert status == 422 and "nope" in res["detail"]
