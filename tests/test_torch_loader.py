"""The port's checkpoint loader, registry and checkpoint serving against the
JAX package.

- safetensors: each package's reader on the other's files (F16, BF16, F32,
  bit-exact), metadata, fp8 read as torch's float8; .ckpt through torch's restricted
  unpickler, a malicious pickle and a legacy file refused.
- The five key manifests at full shape on ``meta``: family, derived
  configs against the family constants, every tensor placed, a missing one
  named, junk dropped with a warning.
- The slice: one ldm-layout file per family (SD1, SD2 in open_clip layout,
  SDXL base + refiner) made from JAX tiny models; JAX's and the port's
  load_model → process_txt2img under an fp32 policy agree within 1 uint8
  level with identical infotext, Model hash included.
- The registry and its hash cache, the VAE chain, reload_checkpoint's LRU
  and parking (a failed load keeps the live model and leaves no
  duplicate), and the checkpoint routes on a tiny server.  Every file is
  written under tmp_path.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import dataclasses
import json
import logging
import os
import pickle
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.loader import load as jax_load
from sdwebui_tpu.loader import safetensors_io as jax_st
from sdwebui_tpu.loader.torch_ckpt import load_torch_checkpoint as jax_load_ckpt
from sdwebui_tpu.models import configs as jax_configs
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.loader import load, safetensors_io, sniff
from sdwebui_tpu_torch.loader.registry import CheckpointRegistry, file_sha256
from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_checkpoint
from sdwebui_tpu_torch.models import configs
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.server.app import CheckpointNotFound, Engine
from sdwebui_tpu_torch.utils import devices as port_devices
from sdwebui_tpu_torch.utils.options import opts
from test_key_manifests import ignorable, load_manifest
from test_torch_models import _perturbed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models' ops are too small to split over threads; with
    several test workers on the machine's cores, extra threads only wait
    on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# --------------------------------------------------------------------------
# safetensors and .ckpt
# --------------------------------------------------------------------------

_DTYPES = [("F16", np.float16, torch.float16), ("F32", np.float32, torch.float32),
           ("BF16", None, torch.bfloat16)]


@pytest.mark.parametrize("name,np_dtype,torch_dtype", _DTYPES, ids=[d[0] for d in _DTYPES])
def test_safetensors_cross_reader(tmp_path, name, np_dtype, torch_dtype):
    """Bit-exact both ways, metadata included."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 7)).astype(np.float32)
    a = a.astype(ml_dtypes.bfloat16) if name == "BF16" else a.astype(np_dtype)
    ids = np.arange(6, dtype=np.int64).reshape(2, 3)
    jax_file, port_file = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jax_st.write_safetensors(jax_file, {"w": a, "ids": ids}, metadata={"format": "pt"})
    f = safetensors_io.SafetensorsFile(jax_file)
    assert f.metadata == {"format": "pt"}
    w = f.tensor("w")
    assert w.dtype == torch_dtype and w.shape == a.shape
    np.testing.assert_array_equal(w.view(torch.int16 if name != "F32" else torch.int32).numpy(),
                                  a.view(np.int16 if name != "F32" else np.int32))
    np.testing.assert_array_equal(f.tensor("ids").numpy(), ids)

    safetensors_io.write_safetensors(port_file, {"w": w, "ids": torch.from_numpy(ids)},
                                     metadata={"step": 3})
    back = jax_st.read_state_dict(port_file)
    assert back["w"].dtype == a.dtype
    np.testing.assert_array_equal(back["w"].view(np.uint8), a.view(np.uint8))
    np.testing.assert_array_equal(back["ids"], ids)
    assert safetensors_io.read_metadata(port_file) == jax_st.read_metadata(port_file) == \
        {"step": "3"}


def test_safetensors_refuses_fp8(tmp_path):
    """fp8 tensors are read now (SD3's T5 bundles): F8_E4M3 and F8_E5M2
    come back as torch's float8 dtypes with JAX's values."""
    import ml_dtypes

    p = str(tmp_path / "fp8.safetensors")
    w = np.linspace(-3, 3, 8, dtype=np.float32)
    jax_st.write_safetensors(p, {"w": w.astype(ml_dtypes.float8_e4m3fn),
                                 "v": w.astype(ml_dtypes.float8_e5m2)})
    sd = safetensors_io.read_state_dict(p)
    assert (sd["w"].dtype, sd["v"].dtype) == (torch.float8_e4m3fn, torch.float8_e5m2)
    ref = jax_st.read_state_dict(p)
    for k in ("w", "v"):
        np.testing.assert_array_equal(sd[k].float().numpy(), np.asarray(ref[k], np.float32))


def test_ckpt_through_weights_only(tmp_path, monkeypatch):
    """A .ckpt with a nested state_dict and an ldm-style step counter (a
    numpy scalar pickled under numpy.core.multiarray, with numpy.dtype and
    _codecs.encode): the port reads what JAX reads."""
    import types

    real_scalar = np.array(0, np.int64)[()].__reduce__()[0]
    fake = types.ModuleType("numpy.core.multiarray")

    def scalar(*a):
        return real_scalar(*a)
    scalar.__module__, scalar.__qualname__ = "numpy.core.multiarray", "scalar"
    fake.scalar = scalar

    class Step:
        def __reduce__(self):
            return scalar, (np.dtype("int64"), np.int64(470000).tobytes())

    sd = {"model.w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
          "model.h": torch.ones(4, dtype=torch.float16),
          "emb": {"b": torch.randn(3, 2, dtype=torch.bfloat16)}}
    p = str(tmp_path / "m.ckpt")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "numpy.core.multiarray", fake)
        torch.save({"state_dict": sd, "global_step": Step()}, p)
    ours, theirs = load_torch_checkpoint(p), jax_load_ckpt(p)
    assert set(ours) == set(theirs) == {"model.w", "model.h", "emb.b"}
    for k, v in ours.items():
        assert v.dtype == sd[k.split(".")[0]]["b"].dtype if k == "emb.b" else sd[k].dtype
        np.testing.assert_array_equal(v.float().numpy(), np.asarray(theirs[k], np.float32))


def test_ckpt_refuses_malicious_and_legacy(tmp_path):
    class Evil:
        def __reduce__(self):
            return os.system, ("echo pwned",)

    p = str(tmp_path / "evil.ckpt")
    torch.save({"state_dict": Evil()}, p)
    with pytest.raises(pickle.UnpicklingError):
        load_torch_checkpoint(p)
    legacy = str(tmp_path / "legacy.ckpt")
    torch.save({"w": torch.ones(2)}, legacy, _use_new_zipfile_serialization=False)
    with pytest.raises(ValueError, match="legacy"):
        load_torch_checkpoint(legacy)


# --------------------------------------------------------------------------
# the key manifests at full shape on meta
# --------------------------------------------------------------------------

def _meta_state_dict(manifest):
    return {k: torch.empty(shape, device="meta", dtype=torch.int64 if k.endswith(
        ("position_ids", "num_updates")) else torch.float16) for k, shape in manifest.items()}


def _canonical(cfg):
    """A UNet config with its per-level depths zeroed where the level has no
    attention, its resolutions sorted and its middle depth resolved: two
    configs that build the same network compare equal."""
    ds = [2 ** i for i in range(len(cfg.channel_mult))]
    depth = tuple(d if r in cfg.attention_resolutions else 0
                  for d, r in zip(cfg.transformer_depth, ds))
    mid = cfg.transformer_depth_middle
    if mid < 0:
        mid = cfg.transformer_depth[-1] if cfg.transformer_depth[-1] > 0 else 1
    return dataclasses.replace(cfg, transformer_depth=depth, transformer_depth_middle=mid,
                               attention_resolutions=tuple(sorted(cfg.attention_resolutions)))


MANIFESTS = [
    ("sd15", "sd1", configs.SD15_UNET, [configs.CLIP_L]),
    ("sd15_inpaint", "sd1", configs.SD15_INPAINT_UNET, [configs.CLIP_L]),
    # SD2 checkpoints carry open_clip's text_projection, which the port keeps
    ("sd21", "sd2", configs.SD21_UNET,
     [dataclasses.replace(configs.OPEN_CLIP_H, projection_dim=1024)]),
    ("sdxl_base", "sdxl", configs.SDXL_UNET, [configs.CLIP_L, configs.OPEN_CLIP_BIGG]),
    ("sdxl_refiner", "sdxl-refiner", configs.SDXL_REFINER_UNET, [configs.OPEN_CLIP_BIGG]),
]


@pytest.mark.parametrize("name,family,unet_cfg,clip_cfgs", MANIFESTS,
                         ids=[m[0] for m in MANIFESTS])
def test_manifest_loads_strictly_on_meta(name, family, unet_cfg, clip_cfgs, caplog):
    sd = _meta_state_dict(load_manifest(name))
    assert sniff.sniff(sd).family == family
    with caplog.at_level(logging.WARNING, logger="sdwebui_tpu_torch"):
        model = load.model_from_state_dict(sd, device="meta", title=name)
    assert not caplog.records, [r.message for r in caplog.records]   # nothing dropped
    assert model.kind == family and all(t.is_meta for t in model.unet.parameters())
    assert _canonical(model.unet_cfg) == _canonical(unet_cfg)
    assert model.vae_cfg == (configs.SDXL_VAE if family.startswith("sdxl") else configs.SD_VAE)
    conds = [c for c in (model.conditioner, model.conditioner2) if c is not None]
    assert [c.cfg for c in conds] == clip_cfgs
    # every tensor of the file is a parameter of a module, or ignorable
    placed = set()
    prefixes = {"model.diffusion_model.": model.unet, "first_stage_model.": model.vae}
    for prefix, module in prefixes.items():
        placed |= {prefix + k for k in module.state_dict()}
    stray = {k for k in sd if k not in placed and not ignorable(k)
             and not k.startswith(("cond_stage_model.", "conditioner."))}
    assert not stray, sorted(stray)[:5]
    n_text = sum(1 for k in sd if k.startswith(("cond_stage_model.", "conditioner."))
                 and not ignorable(k))
    n_params = sum(len(c.model.state_dict()) for c in conds)
    # open_clip's fused in_proj weight and bias are 3 tensors each in the port
    n_fused = sum(1 for k in sd if k.endswith(("attn.in_proj_weight", "attn.in_proj_bias")))
    assert n_params == n_text + 2 * n_fused


@pytest.mark.parametrize("name,victim", [
    ("sd15", "model.diffusion_model.input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight"),
    ("sd15_inpaint", "first_stage_model.decoder.up.2.block.1.conv1.weight"),
    ("sd21", "cond_stage_model.model.transformer.resblocks.7.mlp.c_fc.weight"),
    ("sdxl_base", "conditioner.embedders.0.transformer.text_model.encoder.layers.3.mlp.fc1.bias"),
    ("sdxl_refiner", "model.diffusion_model.out.2.weight"),
])
def test_manifest_missing_tensor_is_named(name, victim):
    sd = _meta_state_dict(load_manifest(name))
    del sd[victim]
    short = victim.split("resblocks.7.")[-1].replace("c_fc", "fc1") if "resblocks" in victim \
        else victim.rsplit(".", 4)[-1]
    with pytest.raises(ValueError, match="missing") as e:
        load.model_from_state_dict(sd, device="meta")
    assert short in str(e.value)


def test_manifest_junk_dropped_with_warning(caplog):
    sd = _meta_state_dict(load_manifest("sd15"))
    sd["model.diffusion_model.middle_block.0.bogus_extra.weight"] = torch.empty(
        8, 8, device="meta")
    with caplog.at_level(logging.WARNING, logger="sdwebui_tpu_torch"):
        model = load.model_from_state_dict(sd, device="meta")
    assert "bogus_extra" not in str(model.unet.state_dict().keys())
    assert any("unexpected" in r.message and "bogus_extra" in r.message for r in caplog.records)


def test_unported_families_raise():
    """Every family and variant the JAX loader takes is ported now: SD3,
    AltDiffusion and the unclip variant get past the family gate, and these
    stub state dicts fail on their missing tensors instead (the whole
    models load in test_torch_sd3 / _alt / _unclip)."""
    unet_key = "model.diffusion_model.input_blocks.0.0.weight"
    sd2 = "cond_stage_model.model.transformer.resblocks.0.attn.in_proj_weight"
    assert {"sd3", "alt"} <= set(load.FAMILIES)
    cases = [({"model.diffusion_model.x_embedder.proj.weight": torch.empty(1, 1)}, "sd3"),
             ({unet_key: torch.empty(32, 4, 3, 3),
               "cond_stage_model.roberta.embeddings.word_embeddings.weight": torch.empty(1)},
              "alt"),
             ({unet_key: torch.empty(32, 4, 3, 3), sd2: torch.empty(1),
               "noise_augmentor.data_mean": torch.empty(1)}, "unclip")]
    for sd, name in cases:
        assert sniff.sniff(sd).family == name or sniff.sniff(sd).variant == name
        with pytest.raises((KeyError, ValueError, TypeError)) as err:
            load.model_from_state_dict(sd, device="cpu")
        assert err.type is not NotImplementedError


# --------------------------------------------------------------------------
# checkpoint files made from JAX tiny models
# --------------------------------------------------------------------------

def _ldm(tree, prefix):
    return {prefix + k: v for k, v in port_sd.state_dict_from_tree(tree).items()}


def _hf_clip(tree, prefix):
    out = _ldm(tree, prefix)
    out[prefix + "embeddings.position_ids"] = torch.arange(77)[None]    # dropped
    return out


def _open_clip(tree, prefix):
    """An open_clip text tower's keys from a CLIP tree: q, k, v fused into
    in_proj, (in, out) text_projection, logit_scale (dropped)."""
    sd = port_sd.state_dict_from_tree(tree)
    out = {prefix + "token_embedding.weight": sd["embeddings.token_embedding.weight"],
           prefix + "positional_embedding": sd["embeddings.position_embedding.weight"],
           prefix + "ln_final.weight": sd["final_layer_norm.weight"],
           prefix + "ln_final.bias": sd["final_layer_norm.bias"],
           prefix + "logit_scale": torch.tensor(4.6052)}
    if "text_projection.weight" in sd:
        out[prefix + "text_projection"] = sd["text_projection.weight"].t().contiguous()
    layers = {int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers.")}
    for i in sorted(layers):
        b, o = f"encoder.layers.{i}.", f"{prefix}transformer.resblocks.{i}."
        for kind in ("weight", "bias"):
            out[o + f"attn.in_proj_{kind}"] = torch.cat(
                [sd[b + f"self_attn.{n}_proj.{kind}"] for n in "qkv"])
            for ours, theirs in (("self_attn.out_proj", "attn.out_proj"), ("layer_norm1", "ln_1"),
                                 ("layer_norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"),
                                 ("mlp.fc2", "mlp.c_proj")):
                out[o + f"{theirs}.{kind}"] = sd[b + f"{ours}.{kind}"]
    return out


@pytest.fixture(scope="module")
def jax_tiny():
    """Perturbed JAX tiny SD1 and SDXL base, and a tiny refiner UNet."""
    rng = np.random.default_rng(90)
    sd1 = jax_sd.create_tiny_sd(9)
    sd1 = dataclasses.replace(sd1, unet_params=_perturbed(sd1.unet_params, rng),
                              vae_params=_perturbed(sd1.vae_params, rng))
    sd1.conditioner.params = _perturbed(sd1.conditioner.params, rng)
    xl = jax_sd.create_tiny_sdxl(8)
    xl = dataclasses.replace(xl, unet_params=_perturbed(xl.unet_params, rng),
                             vae_params=_perturbed(xl.vae_params, rng))
    for cond in (xl.conditioner, xl.conditioner2):
        cond.params = _perturbed(cond.params, rng)
    refiner_unet = _perturbed(jax_unet.init_params(port_sd.TINY_SDXL_REFINER_UNET, 108,
                                                   dtype=jnp.float32), rng)
    sd2_unet = _perturbed(jax_unet.init_params(dataclasses.replace(
        jax_configs.UNetConfig(**dataclasses.asdict(sd1.unet_cfg)),
        use_linear_in_transformer=True), 19, dtype=jnp.float32), rng)
    return sd1, sd2_unet, xl, refiner_unet


@pytest.fixture(scope="module")
def tiny_files(jax_tiny, tmp_path_factory):
    """{family: path} of the ldm-layout files; SD1 also as a .ckpt."""
    sd1, sd2_unet, xl, refiner_unet = jax_tiny
    d = tmp_path_factory.mktemp("ckpts")
    vae1, vae_xl = _ldm(sd1.vae_params, "first_stage_model."), _ldm(xl.vae_params,
                                                                   "first_stage_model.")
    files = {
        "sd1": {**_ldm(sd1.unet_params, "model.diffusion_model."), **vae1,
                **_hf_clip(sd1.conditioner.params, "cond_stage_model.transformer.text_model.")},
        "sd2": {**_ldm(sd2_unet, "model.diffusion_model."), **vae1,
                **_open_clip(sd1.conditioner.params, "cond_stage_model.model.")},
        "sdxl": {**_ldm(xl.unet_params, "model.diffusion_model."), **vae_xl,
                 **_hf_clip(xl.conditioner.params,
                            "conditioner.embedders.0.transformer.text_model."),
                 **_open_clip(xl.conditioner2.params, "conditioner.embedders.1.model.")},
        "sdxl-refiner": {**_ldm(refiner_unet, "model.diffusion_model."), **vae_xl,
                         **_open_clip(xl.conditioner2.params, "conditioner.embedders.0.model.")},
    }
    paths = {}
    for family, sd in files.items():
        paths[family] = str(d / f"tiny-{family}.safetensors")
        safetensors_io.write_safetensors(paths[family], sd, metadata={"format": "pt"})
    paths["sd1-ckpt"] = str(d / "tiny-sd1.ckpt")
    torch.save({"state_dict": files["sd1"]}, paths["sd1-ckpt"])
    return paths


@pytest.fixture
def f32_policies():
    jax_prev, port_prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    yield
    jax_devices.set_policy(jax_prev)
    port_devices.set_policy(port_prev)


def _both(path):
    sha = file_sha256(path)
    title = os.path.basename(path)
    return (jax_load.load_model(path, title=title, sha256=sha),
            load.load_model(path, title=title, sha256=sha, device="cpu"))


def _request(**kw):
    base = dict(prompt="a (red:1.1) cat, castle", negative_prompt="blurry", seed=21, steps=4,
                width=64, height=64, batch_size=1, cfg_scale=6.5, sampler_name="DPM++ 2M",
                scheduler="Karras", override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return GenerationParams(**base)


def _assert_same_images(ref, out):
    assert len(out.images) == len(ref.images)
    for a, b in zip(out.images, ref.images):
        a, b = a.astype(int), np.asarray(b).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    assert out.infotexts == ref.infotexts


@pytest.mark.parametrize("family", ["sd1", "sd2"])
def test_file_to_image_matches_jax(tiny_files, f32_policies, family):
    jm, pm = _both(tiny_files[family])
    assert (jm.kind, pm.kind) == (family, family)
    for ours, theirs in ((pm.unet_cfg, jm.unet_cfg), (pm.vae_cfg, jm.vae_cfg),
                         (pm.conditioner.cfg, jm.conditioner.cfg)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    ref = jax_proc.process_txt2img(jm, _request())
    out = port_proc.process_txt2img(pm, _request())
    _assert_same_images(ref, out)
    assert f"Model hash: {file_sha256(tiny_files[family])[:10]}" in out.infotexts[0]


def test_sdxl_base_and_refiner_files_match_jax(tiny_files, f32_policies):
    jb, pb = _both(tiny_files["sdxl"])
    jr, pr = _both(tiny_files["sdxl-refiner"])
    assert (pb.kind, pr.kind) == ("sdxl", "sdxl-refiner") and pr.conditioner2 is None
    kw = dict(steps=5, refiner_checkpoint=pr.title, refiner_switch_at=0.8)
    ref = jax_proc.process_txt2img(jb, _request(**kw), refiner_model=jr)
    out = port_proc.process_txt2img(pb, _request(**kw), refiner_model=pr)
    _assert_same_images(ref, out)
    assert f"Refiner: {pr.title}" in out.infotexts[0]


def test_loaded_tensors_are_the_files(tiny_files, monkeypatch):
    """No transposes and no random init: every parameter is the file's
    tensor, read as it is stored (the .ckpt and the .safetensors agree)."""
    from sdwebui_tpu_torch.models import layers

    monkeypatch.setattr(layers, "reset_random", lambda *a: pytest.fail("random init"))
    sd = safetensors_io.read_state_dict(tiny_files["sd1"])
    for path in (tiny_files["sd1"], tiny_files["sd1-ckpt"]):
        model = load.load_model(path, device="cpu")
        for prefix, module in (("model.diffusion_model.", model.unet),
                               ("first_stage_model.", model.vae),
                               ("cond_stage_model.transformer.text_model.",
                                model.conditioner.model)):
            for k, v in module.state_dict().items():
                want = sd[prefix + k].to(v.dtype)      # the policy's cast, nothing else
                np.testing.assert_array_equal(v.float().numpy(), want.float().numpy())
        assert model.unet.input_blocks[0][0].weight.is_contiguous(
            memory_format=torch.channels_last)


def test_nine_channel_unet_loads_and_generating_raises(tmp_path):
    m = port_sd.create_tiny_sd(3, "cpu")
    m.unet = port_sd.UNetModel(dataclasses.replace(port_sd.TINY_UNET, in_channels=9),
                               device="cpu", dtype=torch.float32)
    p = str(tmp_path / "inpaint.safetensors")
    safetensors_io.write_safetensors(p, load.ldm_state_dict(m))
    model = load.load_model(p, device="cpu")
    assert model.unet_cfg.in_channels == 9
    assert len(port_proc.process_txt2img(model, _request(steps=1)).images) == 1
    with pytest.raises(NotImplementedError, match="9-channel"):
        port_proc.process_txt2img(model, _request(steps=1, enable_hr=True, hr_scale=2.0,
                                                  denoising_strength=0.5))


# --------------------------------------------------------------------------
# registry, hash cache, VAE chain
# --------------------------------------------------------------------------

def test_registry_and_hash_cache(tmp_path, monkeypatch):
    d = tmp_path / "ckpts"
    (d / "sub").mkdir(parents=True)
    (d / ".hidden").mkdir()
    for name in ("a.safetensors", "sub/b.ckpt", ".hidden/c.pt", "a.vae.safetensors"):
        (d / name).write_bytes(name.encode())
    cache = tmp_path / "hashes.json"
    reg = CheckpointRegistry([str(d)], cache_path=str(cache))
    assert sorted(reg.checkpoints) == [".hidden/c.pt", "a.safetensors", "sub/b.ckpt"]
    info = reg.find("a")
    sha = info.calculate_sha256(str(cache))
    assert sha == file_sha256(str(d / "a.safetensors")) and len(sha) == 64
    assert list(json.loads(cache.read_text()).values()) == [sha]
    assert reg.find(info.title) is info and reg.find(f"x [{sha[:10]}]") is info
    assert reg.find("sub/b.ckpt").filename == str(d / "sub" / "b.ckpt")
    assert reg.find("nope") is None and reg.find(None) is not None
    # the cache answers without reading the file while mtime and size hold
    monkeypatch.setattr("hashlib.sha256", lambda: pytest.fail("re-hashed"))
    assert file_sha256(str(d / "a.safetensors"), str(cache)) == sha
    monkeypatch.undo()
    monkeypatch.setitem(opts.data, "list_hidden_files", False)
    reg.refresh()
    assert sorted(reg.checkpoints) == ["a.safetensors", "sub/b.ckpt"]


def test_resolve_vae_chain(tmp_path, monkeypatch):
    """As tests/test_loader.py:301-380: Automatic prefers the sibling .vae
    file, then models/VAE by basename; a named VAE is looked up there; with
    the override option off the sibling wins; "None" is the embedded VAE."""
    monkeypatch.chdir(tmp_path)
    ckpt = tmp_path / "mymodel.safetensors"
    ckpt.write_bytes(b"x")
    vaedir = tmp_path / "models" / "VAE"
    vaedir.mkdir(parents=True)
    for choice in ("Automatic", "special", "None"):
        monkeypatch.setitem(opts.data, "sd_vae", choice)
        assert load.resolve_vae(str(ckpt)) is None
        assert jax_load.resolve_vae(str(ckpt)) is None
    (vaedir / "mymodel.vae.safetensors").write_bytes(b"x")
    (vaedir / "special.vae.pt").write_bytes(b"x")
    sibling = tmp_path / "mymodel.vae.safetensors"
    expect = {"Automatic": os.path.join("models", "VAE", "mymodel.vae.safetensors"),
              "special": os.path.join("models", "VAE", "special.vae.pt"), "None": None}
    for with_sibling in (False, True):
        if with_sibling:
            sibling.write_bytes(b"x")
            expect["Automatic"] = str(sibling)
        for override in (True, False):
            monkeypatch.setitem(opts.data, "sd_vae_overrides_per_model_preferences", override)
            for choice, want in expect.items():
                monkeypatch.setitem(opts.data, "sd_vae", choice)
                if choice == "special" and with_sibling and not override:
                    want = str(sibling)
                assert load.resolve_vae(str(ckpt)) == want, (choice, with_sibling, override)


def test_sd_checkpoint_cache(tmp_path, monkeypatch):
    p = tmp_path / "m.safetensors"
    safetensors_io.write_safetensors(str(p), {"w": torch.ones(2)})
    load._SD_CACHE.clear()
    monkeypatch.setitem(opts.data, "sd_checkpoint_cache", 2)
    a = load.read_checkpoint(str(p))
    assert load.read_checkpoint(str(p)) is a and len(load._SD_CACHE) == 1
    monkeypatch.setitem(opts.data, "sd_checkpoint_cache", 0)
    assert load.read_checkpoint(str(p)) is not a
    load._SD_CACHE.clear()


# --------------------------------------------------------------------------
# reload_checkpoint and the routes
# --------------------------------------------------------------------------

def _write_tiny(path, seed):
    safetensors_io.write_safetensors(str(path), load.ldm_state_dict(
        port_sd.create_tiny_sd(seed, "cpu")))


@pytest.fixture
def ckpt_engine(tmp_path):
    d = tmp_path / "ckpts"
    d.mkdir()
    _write_tiny(d / "a.safetensors", 1)
    _write_tiny(d / "b.safetensors", 2)
    engine = Engine(device="cpu", ckpt=str(d / "a.safetensors"), ckpt_dirs=[str(d)],
                    vae_dirs=(str(tmp_path / "vae"),), hash_cache=str(tmp_path / "cache.json"))
    yield engine, d
    opts.data["sd_model_checkpoint"] = None


def test_reload_checkpoint_lru_and_parking(ckpt_engine, monkeypatch):
    engine, d = ckpt_engine
    a = engine.sd_model
    assert a.title == f"a.safetensors [{file_sha256(str(d / 'a.safetensors'))[:10]}]"
    moves = []
    real_to = port_sd.SDModel.to
    monkeypatch.setattr(port_sd.SDModel, "to",
                        lambda self, dev: moves.append((self.title, str(dev))) or real_to(self, dev))
    monkeypatch.setitem(opts.data, "sd_checkpoints_limit", 2)
    engine.reload_checkpoint("b")
    b = engine.sd_model
    assert b.title.startswith("b.safetensors") and list(engine._cache) == ["a.safetensors"]
    assert moves == [(a.title, "cpu")]                 # parked in host RAM
    monkeypatch.setattr(load, "read_checkpoint", lambda *a: pytest.fail("file read"))
    engine.reload_checkpoint(a.title)                  # back from the cache
    assert engine.sd_model is a and list(engine._cache) == ["b.safetensors"]
    monkeypatch.setitem(opts.data, "sd_checkpoints_limit", 1)
    monkeypatch.setitem(opts.data, "sd_checkpoints_keep_in_cpu", False)
    moves.clear()
    engine.reload_checkpoint("b")                      # cached: no read; a dropped
    assert engine.sd_model is b and engine._cache == {} and moves == [(b.title, "cpu")]


def test_failed_load_keeps_the_live_model(ckpt_engine, monkeypatch):
    """JAX parks the live model before loading, so a failed load leaves a
    parked duplicate of it in the cache (server/app.py:208-226); the port
    keeps the live model on its device and the cache as it was."""
    engine, d = ckpt_engine
    live = engine.sd_model
    (d / "broken.safetensors").write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00{not json}")
    engine.registry.refresh()
    monkeypatch.setitem(opts.data, "sd_checkpoints_limit", 3)
    engine.reload_checkpoint("b")
    b, cache_before = engine.sd_model, dict(engine._cache)
    with pytest.raises(ValueError):
        engine.reload_checkpoint("broken")
    assert engine.sd_model is b and engine._cache == cache_before
    assert b.device == engine.device and live is cache_before["a.safetensors"]
    with pytest.raises(CheckpointNotFound, match="nope"):
        engine.reload_checkpoint("nope")
    assert engine.sd_model is b


def test_missing_ckpt_is_an_error(tmp_path):
    from sdwebui_tpu_torch.server.__main__ import main

    with pytest.raises(FileNotFoundError, match="missing"):
        Engine(device="cpu", ckpt=str(tmp_path / "missing.safetensors"),
               ckpt_dirs=[str(tmp_path)], hash_cache=None)
    with pytest.raises(FileNotFoundError):
        main(["--device", "cpu", "--ckpt", str(tmp_path / "missing.safetensors"),
              "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        main(["--model", "sd15", "--ckpt", "x.safetensors"])


def _call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_checkpoint_routes(ckpt_engine, tmp_path, monkeypatch):
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.utils.png import decode_png

    engine, d = ckpt_engine
    monkeypatch.setitem(opts.data, "sd_checkpoints_limit", 2)
    (tmp_path / "vae").mkdir()
    _write_vae = port_sd.create_tiny_sd(5, "cpu").vae.state_dict()
    safetensors_io.write_safetensors(str(tmp_path / "vae" / "soft.vae.safetensors"),
                                     {"first_stage_model." + k: v for k, v in _write_vae.items()})
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, models = _call(url, "/sdapi/v1/sd-models")
        assert status == 200 and [m["model_name"] for m in models] == ["a", "b"]
        assert _call(url, "/sdapi/v1/options")[1]["sd_model_checkpoint"] is None  # not loaded
        req = {"prompt": "a cat", "seed": 3, "steps": 2, "width": 64, "height": 64}
        status, res = _call(url, "/sdapi/v1/txt2img", req)
        img_a, info = decode_png(base64.b64decode(res["images"][0]))
        assert status == 200 and "Model: a.safetensors," in info["parameters"]
        assert _call(url, "/sdapi/v1/options")[1]["sd_model_checkpoint"].startswith("a.")
        assert _call(url, "/sdapi/v1/options", {"sd_model_checkpoint": "b"}) == (200, {})
        assert _call(url, "/sdapi/v1/options")[1]["sd_model_checkpoint"].startswith("b.")
        img_b = decode_png(base64.b64decode(_call(url, "/sdapi/v1/txt2img", req)[1]["images"][0]))
        assert np.abs(img_b[0].astype(int) - img_a.astype(int)).max() > 0
        # per request, back to a: the same image as before, from the cache
        status, res = _call(url, "/sdapi/v1/txt2img",
                            {**req, "override_settings": {"sd_model_checkpoint": "a"}})
        again, info = decode_png(base64.b64decode(res["images"][0]))
        np.testing.assert_array_equal(again, img_a)
        # a VAE by name, per request: its hash and name in the infotext
        status, res = _call(url, "/sdapi/v1/txt2img",
                            {**req, "override_settings": {"sd_vae": "soft"}})
        text = decode_png(base64.b64decode(res["images"][0]))[1]["parameters"]
        vae_hash = file_sha256(str(tmp_path / "vae" / "soft.vae.safetensors"))[:10]
        assert status == 200 and f"VAE hash: {vae_hash}, VAE: soft.vae" in text
        assert [v["model_name"] for v in _call(url, "/sdapi/v1/sd-vae")[1]] == ["soft.vae"]
        assert "karras" in [s["name"] for s in _call(url, "/sdapi/v1/schedulers")[1]]
        # a new file shows after a refresh; unload, then reload the setting
        _write_tiny(d / "c.safetensors", 4)
        assert len(_call(url, "/sdapi/v1/sd-models")[1]) == 2
        assert _call(url, "/sdapi/v1/refresh-checkpoints", {}) == (200, {})
        assert [m["model_name"] for m in _call(url, "/sdapi/v1/sd-models")[1]] == ["a", "b", "c"]
        assert _call(url, "/sdapi/v1/unload-checkpoint", {}) == (200, {})
        assert engine._model is None
        assert _call(url, "/sdapi/v1/reload-checkpoint", {}) == (200, {})
        assert engine.sd_model.title.startswith("b.")    # opts.sd_model_checkpoint
        for body in ({"sd_model_checkpoint": "nope"}, {"samples_log_stdout": True}):
            status, res = _call(url, "/sdapi/v1/options", body)
            assert status == 422 and next(iter(body.values() if "nope" in str(body)
                                               else body)) in res["detail"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
