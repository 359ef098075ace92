"""Extra networks in the port against the JAX package (CPU, f32): every
LoRA / LyCORIS algebra on a tiny UNet, key resolution of the kohya, compvis
and diffusers SDXL names, textual-inversion conds (SD1 and an SDXL
clip_l / clip_g pair, a LoRA-bundled embedding), the hypernetwork UNet,
whole txt2img runs with tags through both packages' ``process_txt2img``,
and the base weights after tagged requests.  Inputs are made with numpy
import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
from a seed; tolerances are stated per test."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.networks import extra_networks as jax_en
from sdwebui_tpu.networks import hypernetwork as jax_hn
from sdwebui_tpu.networks import lora as jax_lora
from sdwebui_tpu.networks import textual_inversion as jax_ti
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.networks import NetworkNotFound
from sdwebui_tpu_torch.networks import extra_networks as port_en
from sdwebui_tpu_torch.networks import hypernetwork as port_hn
from sdwebui_tpu_torch.networks import lora as port_lora
from sdwebui_tpu_torch.networks import textual_inversion as port_ti
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_models import _assert_rel, _nchw, _nhwc, _perturbed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(11)
    rng = np.random.default_rng(110)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng),
                             vae_params=_perturbed(jm.vae_params, rng))
    jm.conditioner.params = _perturbed(jm.conditioner.params, rng)
    return jm, port_sd.from_jax(jm, device="cpu")


@pytest.fixture
def f32_policies():
    jax_prev, port_prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    yield
    jax_devices.set_policy(jax_prev)
    port_devices.set_policy(port_prev)


# --------------------------------------------------------------------------
# LoRA algebras
# --------------------------------------------------------------------------

LINEAR = "input_blocks.1.1.transformer_blocks.0.attn1.to_q"    # (32, 32)
CONV = "input_blocks.1.0.in_layers.2"                         # (32, 32, 3, 3)
CONV1X1 = "input_blocks.1.1.proj_in"                          # (32, 32, 1, 1)
NORM = "input_blocks.1.1.transformer_blocks.0.norm1"          # (32,)


def _algebra(name: str, rng):
    """(module path, {suffix: array}) of one network module."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3  # noqa: E731
    alpha = np.float32(3.0)
    if name == "lora_linear":
        return LINEAR, {"lora_up.weight": f(32, 4), "lora_down.weight": f(4, 32), "alpha": alpha}
    if name == "lora_conv3x3":
        return CONV, {"lora_up.weight": f(32, 4, 1, 1), "lora_down.weight": f(4, 32, 3, 3),
                      "alpha": alpha}
    if name == "lora_conv1x1":
        return CONV1X1, {"lora_up.weight": f(32, 4, 1, 1), "lora_down.weight": f(4, 32, 1, 1)}
    if name == "hada":
        return LINEAR, {"hada_w1_a": f(32, 4), "hada_w1_b": f(4, 32), "hada_w2_a": f(32, 4),
                        "hada_w2_b": f(4, 32), "alpha": alpha}
    if name == "lokr":
        return LINEAR, {"lokr_w1": f(4, 4), "lokr_w2": f(8, 8)}
    if name == "lokr_ab":
        return LINEAR, {"lokr_w1_a": f(4, 2), "lokr_w1_b": f(2, 4), "lokr_w2_a": f(8, 3),
                        "lokr_w2_b": f(3, 8), "alpha": alpha}
    if name == "lokr_t2":
        return CONV, {"lokr_w1": f(4, 4), "lokr_t2": f(2, 3, 3, 3), "lokr_w2_a": f(2, 8),
                      "lokr_w2_b": f(3, 8), "alpha": alpha}
    if name == "full":
        return CONV, {"weight": f(32, 32, 3, 3)}
    if name == "diff":
        return LINEAR, {"diff": f(32, 32)}
    if name == "ia3_out":
        return LINEAR, {"w": f(32) + 1, "on_input": np.asarray(0)}
    if name == "ia3_in":
        return CONV, {"w": f(32) + 1, "on_input": np.asarray(1)}
    if name == "norm":
        return NORM, {"w_norm": f(32), "b_norm": f(32)}
    if name == "glora":
        return LINEAR, {"a1.weight": f(4, 32), "a2.weight": f(32, 4), "b1.weight": f(4, 32),
                        "b2.weight": f(32, 4)}
    if name == "oft":
        return LINEAR, {"oft_blocks": f(4, 8, 8), "alpha": np.float32(0.01)}
    if name == "dora":
        return LINEAR, {"lora_up.weight": f(32, 4), "lora_down.weight": f(4, 32), "alpha": alpha,
                        "dora_scale": np.abs(f(32, 1)) + 1}
    raise ValueError(name)


ALGEBRAS = ["lora_linear", "lora_conv3x3", "lora_conv1x1", "hada", "lokr", "lokr_ab",
            "lokr_t2", "full", "diff", "ia3_out", "ia3_in", "norm", "glora", "oft", "dora"]


@pytest.mark.parametrize("algebra", ALGEBRAS)
def test_lora_algebra_matches_jax(models, algebra):
    """The port's merge against JAX's ``apply_loras`` on the same tiny tree
    (two networks on one module, multipliers 0.7 and -0.4): every patched
    tensor within max|Δ| <= 1e-6 · max|W| (f32)."""
    jm, pm = models
    rng = np.random.default_rng(ALGEBRAS.index(algebra))
    path, mods = _algebra(algebra, rng)
    prefix = "lora_unet_" + path.replace(".", "_") + "."
    second = {prefix + "lora_up.weight": rng.standard_normal((32, 2)).astype(np.float32),
              prefix + "lora_down.weight": rng.standard_normal((2, 32)).astype(np.float32)} \
        if path == LINEAR else {}
    sd = {prefix + k: v for k, v in mods.items()}
    ref_tree, n_ref, unmatched = jax_lora.apply_loras(jm.unet_params, [(sd, 0.7), (second, -0.4)])
    assert not unmatched and n_ref == 1 + bool(second)
    port_sd_ = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    port_second = {k: torch.from_numpy(v) for k, v in second.items()}
    params = dict(pm.unet.named_parameters())
    patched, n, unmatched = port_lora.apply_loras(params, [(port_sd_, 0.7), (port_second, -0.4)])
    assert not unmatched and n == n_ref
    ref = port_sd.state_dict_from_tree(ref_tree)
    assert set(patched) == {path + ".weight"} | ({path + ".bias"} if algebra == "norm" else set())
    for name, t in patched.items():
        scale = float(ref[name].abs().max())
        err = float((t - ref[name]).abs().max())
        assert err <= 1e-6 * scale, (name, err, scale)
        assert not torch.equal(t, params[name])
        assert params[name].data_ptr() != t.data_ptr()


SDXL_NAMES = [
    # kohya / compvis (ldm module paths)
    "input_blocks_4_1_transformer_blocks_0_attn1_to_q",
    "input_blocks_1_0_in_layers_2",
    "middle_block_1_proj_in",
    "output_blocks_2_2_conv",
    "label_emb_0_0",
    # diffusers SDXL names
    "down_blocks_1_attentions_0_transformer_blocks_0_attn2_to_k",
    "down_blocks_1_attentions_1_proj_out",
    "down_blocks_0_resnets_1_conv1",
    "down_blocks_1_resnets_0_conv_shortcut",
    "down_blocks_0_downsamplers_0_conv",
    "mid_block_attentions_0_transformer_blocks_0_ff_net_2",
    "mid_block_resnets_1_time_emb_proj",
    "up_blocks_0_attentions_2_transformer_blocks_0_attn1_to_out_0",
    "up_blocks_1_resnets_2_conv2",
    "no_such_module",
]


@pytest.mark.parametrize("key", SDXL_NAMES)
def test_key_resolution_matches_jax(key):
    """The same module in both packages for the names of a tiny SDXL UNet
    (and None for an unknown name)."""
    params = jax_unet.init_params(port_sd.TINY_SDXL_UNET, 0, dtype=jnp.float32)
    names = port_sd.state_dict_from_tree(params)
    ref = jax_lora.resolve_module(key, jax_lora.build_path_lookup(params))
    out = port_lora.resolve_module(key, port_lora.build_path_lookup(names))
    assert out == ref
    assert (ref is None) == (key == "no_such_module")


@pytest.mark.parametrize("family,block,slot", [("sdxl", 0, 2), ("sdxl", 1, 2), ("sd15", 0, 1),
                                               ("sd15", 1, 2), ("sd15", 2, 2)])
def test_diffusers_upsampler_slot_follows_the_model(family, block, slot):
    """A diffusers up block's upsampler conv lands in its last output
    block's slot 2 where that block holds a transformer, else slot 1: SDXL's
    up_blocks_0 (output block 2) has one, SD1's has none.  JAX's fixed SD1
    map (sdwebui_tpu/networks/lora.py:57-58) sends SDXL's to slot 1, which
    no module holds; the full-width UNets are built on meta."""
    from sdwebui_tpu_torch.models.configs import SD15_UNET, SDXL_UNET
    from sdwebui_tpu_torch.models.unet import UNetModel

    cfg = SDXL_UNET if family == "sdxl" else SD15_UNET
    names = UNetModel(cfg, device="meta", dtype=torch.float16).state_dict()
    lookup = port_lora.build_path_lookup(names)
    out = port_lora.resolve_module(f"up_blocks_{block}_upsamplers_0_conv", lookup)
    assert out == f"output_blocks.{3 * block + 2}.{slot}.conv"
    if family == "sdxl" and block == 0:
        assert jax_lora.resolve_module("up_blocks_0_upsamplers_0_conv",
                                       jax_lora.build_path_lookup(names)) is None


def test_sdxl_upsampler_lora_patches_its_conv():
    """A LoRA on an SDXL-named upsampler key changes that conv (tiny SDXL,
    whose up block 0 holds a transformer) and nothing else."""
    unet = port_sd.create_tiny_sdxl(0, "cpu").unet
    params = dict(unet.named_parameters())
    w = params["output_blocks.2.2.conv.weight"]
    rng = np.random.default_rng(7)
    lora = {"lora_unet_up_blocks_0_upsamplers_0_conv.lora_down.weight":
            torch.from_numpy(rng.standard_normal((4, w.shape[1], 3, 3), dtype=np.float32)),
            "lora_unet_up_blocks_0_upsamplers_0_conv.lora_up.weight":
            torch.from_numpy(rng.standard_normal((w.shape[0], 4, 1, 1), dtype=np.float32)),
            "lora_unet_up_blocks_0_upsamplers_0_conv.alpha": torch.tensor(4.0)}
    patched, n, unmatched = port_lora.apply_loras(params, [(lora, 0.5)])
    assert n == 1 and not unmatched and set(patched) == {"output_blocks.2.2.conv.weight"}
    assert not torch.equal(patched["output_blocks.2.2.conv.weight"], w)


def test_text_encoder_key_resolution(models):
    jm, pm = models
    lookup_j = jax_lora.build_path_lookup(jm.conditioner.params)
    lookup_p = port_lora.build_path_lookup(dict(pm.conditioner.model.named_parameters()))
    for key in ("text_model_encoder_layers_1_self_attn_q_proj",
                "text_model_encoder_layers_0_mlp_fc2", "encoder_layers_1_self_attn_out_proj"):
        assert port_lora.resolve_module(key, lookup_p) == \
            jax_lora.resolve_module(key, lookup_j) is not None


# --------------------------------------------------------------------------
# textual inversion
# --------------------------------------------------------------------------

PROMPTS = ["a photo of tiemb, best", "tiemb", "plain words only", "two tiemb and bemb here"]


def _dbs(tok, vec, bundled):
    """(JAX db, port db) holding the same embeddings."""
    jdb, pdb = jax_ti.EmbeddingDatabase(tok, 64), port_ti.EmbeddingDatabase(tok, 64)
    jdb.register(jax_ti.Embedding("tiemb", vec))
    pdb.register(port_ti.Embedding("tiemb", torch.from_numpy(vec)))
    sd = {"bundle_emb.bemb.string_to_param.*": bundled}
    jax_en.register_bundle_embeddings(type("M", (), {"conditioner": type(
        "C", (), {"embedding_db": jdb})})(), sd)
    port_en.register_bundle_embeddings(type("M", (), {"conditioner": type(
        "C", (), {"embedding_db": pdb})})(), {k: torch.from_numpy(v) for k, v in sd.items()})
    return jdb, pdb


def test_textual_inversion_conds_match_jax(models):
    """SD1 tiny conditioner with a 3-vector embedding and a 2-vector one
    bundled in a LoRA file: conds and pooled within 1e-5 of JAX's, the same
    names logged for the infotext."""
    jm, pm = models
    rng = np.random.default_rng(3)
    jdb, pdb = _dbs(jm.conditioner.tokenizer, rng.standard_normal((3, 64)).astype(np.float32),
                    rng.standard_normal((2, 64)).astype(np.float32))
    jc, pc = jm.conditioner, pm.conditioner
    jc.embedding_db, pc.embedding_db = jdb, pdb
    try:
        ref_c, ref_p = jc.encode(PROMPTS)
        with torch.inference_mode():
            out_c, out_p = pc.encode(PROMPTS)
        chunks, _ = pc.tokenize_line(PROMPTS[0])
        ref_chunks, _ = jc.tokenize_line(PROMPTS[0])
    finally:
        jc.embedding_db = pc.embedding_db = None
    _assert_rel(out_c.numpy(), np.asarray(ref_c), 1e-5)
    _assert_rel(out_p.numpy(), np.asarray(ref_p), 1e-5)
    assert pdb.used_names == jdb.used_names == {"tiemb", "bemb"}
    assert [(pos, e.name) for pos, e in chunks[0].fixes] == \
        [(pos, e.name) for pos, e in ref_chunks[0].fixes] and len(chunks[0].fixes) == 1


@pytest.fixture(scope="module")
def sdxl_models():
    jb = jax_sd.create_tiny_sdxl(7)
    rng = np.random.default_rng(71)
    for cond in (jb.conditioner, jb.conditioner2):
        cond.params = _perturbed(cond.params, rng)
    jb = dataclasses.replace(jb, unet_params=_perturbed(jb.unet_params, rng),
                             vae_params=_perturbed(jb.vae_params, rng))
    return jb, port_sd.from_jax(jb, device="cpu")


def test_sdxl_embedding_pair_matches_jax(sdxl_models):
    """An SDXL clip_l / clip_g embedding: CLIP-L takes clip_l, bigG takes
    clip_g.  JAX's conditioner splices one ``vec`` into both encoders
    (``clip.encode_with_fixes``), so each JAX encoder gets a database whose
    embedding holds that encoder's rows; the port's one database feeds both.
    The concatenated conds within 1e-5."""
    jb, pb = sdxl_models
    rng = np.random.default_rng(4)
    vl = rng.standard_normal((2, 32)).astype(np.float32)
    vg = rng.standard_normal((2, 64)).astype(np.float32)
    tok = jb.conditioner.tokenizer
    jdb_l, jdb_g = jax_ti.EmbeddingDatabase(tok), jax_ti.EmbeddingDatabase(tok)
    jdb_l.register(jax_ti.Embedding("xlemb", vl))
    jdb_g.register(jax_ti.Embedding("xlemb", vg))
    pdb = port_ti.EmbeddingDatabase(tok, 32, 64)
    pdb.register(port_ti.Embedding("xlemb", torch.from_numpy(vl), vec_g=torch.from_numpy(vg)))
    pdb.register(port_ti.Embedding("sd1only", torch.zeros(1, 32)))
    assert list(pdb.embeddings) == ["xlemb"] and pdb.skipped[0].startswith("sd1only")
    jb.conditioner.embedding_db, jb.conditioner2.embedding_db = jdb_l, jdb_g
    pb.conditioner.embedding_db = pb.conditioner2.embedding_db = pdb
    pb.conditioner2.embedding_field = "vec_g"
    texts = ["an xlemb castle", "no trigger"]
    try:
        ref_c, ref_p = jb.encode_texts(texts)
        with torch.inference_mode():
            out_c, out_p = pb.encode_texts(texts)
    finally:
        jb.conditioner.embedding_db = jb.conditioner2.embedding_db = None
        pb.conditioner.embedding_db = pb.conditioner2.embedding_db = None
        pb.conditioner2.embedding_field = "vec"
    _assert_rel(out_c.numpy(), np.asarray(ref_c), 1e-5)
    _assert_rel(out_p.numpy(), np.asarray(ref_p), 1e-5)


@pytest.mark.parametrize("layout", ["safetensors", "sdxl", "pt", "bin"])
def test_embedding_files_load_as_jax(tmp_path, layout):
    rng = np.random.default_rng(5)
    vec = rng.standard_normal((2, 64)).astype(np.float32)
    path = str(tmp_path / f"emb_{layout}.{ 'safetensors' if layout == 'sdxl' else layout}")
    t = torch.from_numpy(vec)
    if layout == "safetensors":
        write_safetensors(path, {"emb_params": t})
    elif layout == "sdxl":
        write_safetensors(path, {"clip_l": t[:, :32].contiguous(), "clip_g": t})
    elif layout == "pt":
        torch.save({"string_to_token": {"*": 265}, "string_to_param": {"*": t},
                    "name": "x", "step": 10}, path)
    else:
        torch.save({"emb_x": t}, path)
    ref = jax_ti.load_embedding_file(path)
    out = port_ti.load_embedding_file(path)
    assert (out.name, out.vectors, out.shorthash) == (ref.name, ref.vectors, ref.shorthash)
    np.testing.assert_array_equal(out.vec.numpy(), np.asarray(ref.vec))
    if layout == "sdxl":
        np.testing.assert_array_equal(out.vec_g.numpy(), np.asarray(ref.vec_g))


@pytest.mark.parametrize("kind", ["panels", "text_chunk", "panels_rgba"])
def test_png_embedding_card_matches_jax(tmp_path, kind):
    """A card the JAX package writes here (its Pillow encoder: the data
    panels, or an ``sd-ti-embedding`` text chunk; an RGBA save too) loads
    in the port as in JAX: the card's name, step, vectors and shorthash;
    so does the panel card saved as a lossless WebP.  A lossy WebP and a
    PNG without data raise in both, and the database skips them."""
    from PIL import Image
    from PIL.PngImagePlugin import PngInfo

    from sdwebui_tpu.training import image_embedding as jax_ie

    rng = np.random.default_rng(12)
    vec = rng.standard_normal((2, 64)).astype(np.float32)
    data = {"string_to_param": {"*": vec}, "name": "card-emb", "step": 150}
    preview = Image.fromarray(rng.integers(1, 255, (64, 48, 3), dtype=np.uint8))
    path = str(tmp_path / "card.png")
    if kind == "text_chunk":
        info = PngInfo()
        info.add_text("sd-ti-embedding", jax_ie.embedding_to_b64(data).decode())
        preview.save(path, pnginfo=info)
    else:
        card = jax_ie.insert_image_data_embed(preview, data)
        (card.convert("RGBA") if kind == "panels_rgba" else card).save(path)
    ref = jax_ti.load_embedding_file(path)
    out = port_ti.load_embedding_file(path)
    assert (out.name, out.step, out.shorthash) == (ref.name, ref.step, ref.shorthash) == (
        "card-emb", 150, out.shorthash)
    np.testing.assert_array_equal(out.vec.numpy(), np.asarray(ref.vec))
    np.testing.assert_array_equal(out.vec.numpy(), vec)
    if kind != "text_chunk":   # the panels survive a lossless WebP
        (tmp_path / "webp").mkdir()
        lossless = str(tmp_path / "webp" / "card.webp")
        Image.open(path).save(lossless, lossless=True)
        ref = jax_ti.load_embedding_file(lossless)
        out = port_ti.load_embedding_file(lossless)
        assert (out.name, out.step, out.shorthash) == (ref.name, ref.step, ref.shorthash)
        np.testing.assert_array_equal(out.vec.numpy(), vec)
    webp = str(tmp_path / "card.webp")
    preview.save(webp)
    for package in (jax_ti, port_ti):
        with pytest.raises(ValueError, match="no embedded embedding data"):
            package.load_embedding_file(webp)
    preview.save(str(tmp_path / "plain.png"))
    db = port_ti.EmbeddingDatabase()
    db.load_from_dir(str(tmp_path))
    assert list(db.embeddings) == ["card-emb"]
    assert sorted(x.split(" ")[0] for x in db.skipped) == ["card.webp", "plain.png"]


# --------------------------------------------------------------------------
# hypernetworks
# --------------------------------------------------------------------------

def _hypernet_file(path: str, dims=(32, 64), seed=0):
    hn = jax_hn.create_hypernetwork(dims=dims, layer_structure=(1, 2, 1), seed=seed,
                                    add_layer_norm=True)
    rng = np.random.default_rng(seed)
    for k_mod, v_mod in hn.values():          # larger than the init's 0.01
        for layer in (*k_mod, *v_mod):
            layer["weight"] = layer["weight"] * 30
            layer["bias"] = rng.standard_normal(layer["bias"].shape).astype(np.float32) * 0.1
            layer["ln_weight"] = 1 + rng.standard_normal(layer["ln_weight"].shape).astype(
                np.float32) * 0.1
    jax_hn.save_hypernetwork(hn, path, name="hn", activation="relu")
    return hn


def test_hypernetwork_unet_matches_jax(models, tmp_path):
    """The tiny UNet with a hypernetwork for widths 32 (self-attention) and
    64 (the context): within 1e-4 of JAX's ``unet.apply(hypernet=)``; the
    reference ``.pt`` layout loads the same network."""
    jm, pm = models
    path = str(tmp_path / "hn.safetensors")
    _hypernet_file(path)
    tree, activation = jax_hn.load_hypernetwork(path)
    hn = port_hn.load_hypernetwork(path, "cpu").with_multiplier(0.8)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    t = np.asarray([900.0, 11.5], np.float32)
    ctx = rng.standard_normal((2, 77, 64), dtype=np.float32)
    cfg = jm.unet_cfg
    ref = np.asarray(jax_unet.apply(jm.unet_params, cfg, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(ctx), hypernet=(tree, (activation, 0.8, False))))
    with torch.inference_mode():
        out = pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), hypernet=hn)
        base = pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    _assert_rel(_nhwc(out), ref, 1e-4)
    assert float((out - base).abs().max()) > 1e-2 * float(base.abs().max())

    # the reference .pt: {width: [k, v] Sequential state dicts}, (out, in) weights
    pt = {"activation_func": "relu", "activate_output": False, "is_layer_norm": True,
          "layer_structure": [1, 2, 1], "name": "hn", "step": 0}
    for dim, (k_mod, v_mod) in tree.items():
        pair = []
        for mod in (k_mod, v_mod):
            sd = {}
            for li, layer in enumerate(mod):
                base_idx = 3 * li               # Linear, ReLU, LayerNorm
                sd[f"linear.{base_idx}.weight"] = torch.tensor(np.asarray(layer["weight"]).T)
                sd[f"linear.{base_idx}.bias"] = torch.tensor(np.asarray(layer["bias"]))
                sd[f"linear.{base_idx + 2}.weight"] = torch.tensor(
                    np.asarray(layer["ln_weight"]))
                sd[f"linear.{base_idx + 2}.bias"] = torch.tensor(np.asarray(layer["ln_bias"]))
            pair.append(sd)
        pt[int(dim)] = pair
    torch.save(pt, str(tmp_path / "hn_ref.pt"))
    hn_pt = port_hn.load_hypernetwork(str(tmp_path / "hn_ref.pt"), "cpu").with_multiplier(0.8)
    with torch.inference_mode():
        out_pt = pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), hypernet=hn_pt)
    _assert_rel(_nhwc(out_pt), ref, 1e-4)


# --------------------------------------------------------------------------
# whole requests
# --------------------------------------------------------------------------

def _lora_file(path: str, unet_names, clip_names, rng, prefix_te="lora_te_"):
    """A rank-4 LoRA over the given UNet and text-encoder modules."""
    sd = {}
    for prefix, names in (("lora_unet_", unet_names), (prefix_te, clip_names)):
        for name, (o, i) in names.items():
            key = prefix + name.replace(".", "_")
            sd[f"{key}.lora_up.weight"] = rng.standard_normal((o, 4)).astype(np.float32) * 0.5
            sd[f"{key}.lora_down.weight"] = rng.standard_normal((4, i)).astype(np.float32) * 0.5
            sd[f"{key}.alpha"] = np.float32(4.0)
    write_safetensors(path, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})


@pytest.fixture
def network_dirs(tmp_path, monkeypatch):
    """LoRA, hypernetwork and embedding files in tmp_path, registered in
    both packages' registries."""
    rng = np.random.default_rng(9)
    lora_dir, hn_dir, emb_dir = (tmp_path / n for n in ("Lora", "hypernetworks", "embeddings"))
    for d in (lora_dir, hn_dir, emb_dir):
        d.mkdir()
    attn = {f"{b}.1.transformer_blocks.0.{a}.{p}": (c, c)
            for b, c in (("input_blocks.1", 32), ("output_blocks.1", 64))
            for a in ("attn1", "attn2") for p in ("to_q", "to_out.0")}
    _lora_file(str(lora_dir / "tlora.safetensors"), attn,
               {"text_model.encoder.layers.1.self_attn.v_proj": (64, 64)}, rng)
    _hypernet_file(str(hn_dir / "thn.safetensors"))
    write_safetensors(str(emb_dir / "tiemb.safetensors"),
                      {"emb_params": torch.from_numpy(rng.standard_normal((2, 64)).astype(
                          np.float32))})
    monkeypatch.setattr(jax_en, "_default_registry", jax_en.LoraRegistry([str(lora_dir)]))
    monkeypatch.setattr(jax_en, "_hypernet_registry", jax_hn.HypernetworkRegistry([str(hn_dir)]))
    jax_en._merge_cache.clear()
    port_en.set_lora_dirs([str(lora_dir)])
    port_hn.set_hypernetwork_dirs([str(hn_dir)])
    yield str(emb_dir)
    port_en.set_lora_dirs(port_en.DEFAULT_LORA_DIRS)
    port_hn.set_hypernetwork_dirs([port_hn.DEFAULT_HYPERNETWORK_DIR])
    jax_en._merge_cache.clear()


def _attach(jm, pm, emb_dir):
    jdb = jax_ti.EmbeddingDatabase(jm.conditioner.tokenizer, 64)
    jdb.load_from_dir(emb_dir)
    jm.conditioner.embedding_db = jdb
    port_ti.attach_embeddings(pm, emb_dir)


def _params(**kw):
    base = dict(prompt="a tiemb cat <lora:tlora:0.8> <hypernet:thn:0.6>",
                negative_prompt="blurry", seed=21, steps=3, width=64, height=64,
                batch_size=2, cfg_scale=7.5, sampler_name="Euler",
                override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return GenerationParams(**base)


def _assert_same_images(out, ref):
    ref_imgs = [np.asarray(im) for im in ref.images[ref.index_of_first_image:]]
    out_imgs = out.images[out.index_of_first_image:]
    assert len(out_imgs) == len(ref_imgs)
    for a, b in zip(out_imgs, ref_imgs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts[out.index_of_first_image:] == \
        ref.infotexts[ref.index_of_first_image:]


def test_txt2img_with_lora_embedding_hypernetwork_matches_jax(models, f32_policies,
                                                              network_dirs):
    """A LoRA (UNet attention and the text encoder), an embedding and a
    hypernetwork through both packages' ``process_txt2img``: within 1 uint8
    level, identical infotext (the tags kept, "TI hashes" named)."""
    jm, pm = models
    _attach(jm, pm, network_dirs)
    try:
        ref = jax_proc.process_txt2img(jm, _params())
        out = port_proc.process_txt2img(pm, _params())
        plain = port_proc.process_txt2img(pm, _params(prompt="a tiemb cat"))
    finally:
        jm.conditioner.embedding_db = pm.conditioner.embedding_db = None
    _assert_same_images(out, ref)
    assert "<lora:tlora:0.8>" in out.infotexts[-1] and 'TI hashes: "tiemb: ' in out.infotexts[-1]
    assert np.abs(out.images[-1].astype(int) - plain.images[-1].astype(int)).max() > 10


def test_tagless_request_sees_base_weights(models, f32_policies, network_dirs):
    """After tagged requests (one merge for the repeated tag set), a
    tagless request runs on weights equal to the base's (torch.equal) and
    gives the image it gave before them."""
    _, pm = models
    pm.network_cache.clear()
    modules = (pm.unet, pm.conditioner.model)
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in modules]
    plain = _params(prompt="a cat", batch_size=1)
    first = port_proc.process_txt2img(pm, plain)
    tagged = _params(prompt="a cat <lora:tlora:1.0>", batch_size=1)
    a = port_proc.process_txt2img(pm, tagged)
    assert len(pm.network_cache) == 1
    (merged,) = pm.network_cache.values()
    b = port_proc.process_txt2img(pm, _params(prompt="a cat <lora:tlora:1.0>", batch_size=1))
    assert len(pm.network_cache) == 1 and next(iter(pm.network_cache.values())) is merged
    np.testing.assert_array_equal(a.images[0], b.images[0])
    port_proc.process_txt2img(pm, _params(prompt="a cat <lora:tlora:0.3>", batch_size=1))
    last = port_proc.process_txt2img(pm, _params(prompt="a cat", batch_size=1))
    for m, ref in zip(modules, before):
        for k, v in m.state_dict().items():
            assert torch.equal(v, ref[k]), k
    np.testing.assert_array_equal(first.images[0], last.images[0])
    assert np.abs(first.images[0].astype(int) - a.images[0].astype(int)).max() > 0
    pm.to("cpu")                        # moving the model drops its merged copies
    assert not pm.network_cache


def test_missing_networks_and_unknown_kinds_raise(models, network_dirs):
    _, pm = models
    with pytest.raises(NetworkNotFound, match="nope"):
        port_proc.process_txt2img(pm, _params(prompt="x <lora:nope:1>", steps=1))
    with pytest.raises(NetworkNotFound, match="nohn"):
        port_proc.process_txt2img(pm, _params(prompt="x <hypernet:nohn:1>", steps=1))
    with pytest.raises(NotImplementedError, match="<foo:"):
        port_proc.process_txt2img(pm, _params(prompt="x <foo:bar>", steps=1))


def test_implicit_hypernetwork_option(models, network_dirs):
    _, pm = models
    clean, model, hn = port_en.activate(pm, "a cat")
    assert (clean, model, hn) == ("a cat", pm, None)
    from sdwebui_tpu_torch.utils.options import opts

    with opts.override({"sd_hypernetwork": "thn", "extra_networks_default_multiplier": 0.5}):
        _, _, hn = port_en.activate(pm, "a cat")
    assert hn.multiplier == 0.5 and sorted(hn.layers) == [32, 64]


def test_sdxl_lora_matches_jax(sdxl_models, f32_policies, tmp_path, monkeypatch):
    """Tiny SDXL with a LoRA on the UNet (a diffusers-named module too), the
    CLIP-L (lora_te1_) and bigG (lora_te2_) encoders: within 1 uint8 level
    of JAX's ``process_txt2img``, identical infotext."""
    jb, pb = sdxl_models
    rng = np.random.default_rng(12)
    sd = {}
    for key, (o, i) in {"lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q": (64, 64),
                        "lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_attn2_to_v":
                            (64, 96),
                        "lora_te1_text_model_encoder_layers_0_self_attn_q_proj": (32, 32),
                        "lora_te2_text_model_encoder_layers_1_mlp_fc1": (256, 64)}.items():
        sd[f"{key}.lora_up.weight"] = rng.standard_normal((o, 4)).astype(np.float32) * 0.5
        sd[f"{key}.lora_down.weight"] = rng.standard_normal((4, i)).astype(np.float32) * 0.5
    d = tmp_path / "Lora"
    d.mkdir()
    write_safetensors(str(d / "xl.safetensors"), {k: torch.from_numpy(v) for k, v in sd.items()})
    monkeypatch.setattr(jax_en, "_default_registry", jax_en.LoraRegistry([str(d)]))
    jax_en._merge_cache.clear()
    port_en.set_lora_dirs([str(d)])
    try:
        kw = dict(prompt="a castle <lora:xl:0.9>", sampler_name="DPM++ 2M", steps=3,
                  batch_size=1)
        ref = jax_proc.process_txt2img(jb, _params(**kw))
        out = port_proc.process_txt2img(pb, _params(**kw))
    finally:
        port_en.set_lora_dirs(port_en.DEFAULT_LORA_DIRS)
        jax_en._merge_cache.clear()
    _assert_same_images(out, ref)
    (unet, clip, clip2), = pb.network_cache.values()
    assert unet is not pb.unet and clip is not pb.conditioner.model \
        and clip2 is not pb.conditioner2.model


def test_extra_network_routes(network_dirs):
    """/loras (with the kohya alias from the file's metadata), /hypernetworks,
    /embeddings and their refreshes, and 404 for a missing network."""
    import shutil

    from sdwebui_tpu_torch.server.api import Api
    from sdwebui_tpu_torch.server.app import Engine

    lora_dir = os.path.join(os.path.dirname(network_dirs), "Lora")
    write_safetensors(os.path.join(lora_dir, "named.safetensors"),
                      {"lora_unet_x.alpha": torch.ones(())}, metadata={"ss_output_name": "nice"})
    api = Api(Engine(device="cpu", tiny=True, embeddings_dir=network_dirs))
    assert api.handle("GET", "/sdapi/v1/loras", None)[1][0]["name"] == "tlora"
    assert api.handle("POST", "/sdapi/v1/refresh-loras", {}) == (200, {})
    loras = {x["name"]: x for x in api.handle("GET", "/sdapi/v1/loras", None)[1]}
    assert loras["named"]["alias"] == "nice" and loras["named"]["metadata"] == {
        "ss_output_name": "nice"}
    assert [h["name"] for h in api.handle("GET", "/sdapi/v1/hypernetworks", None)[1]] == ["thn"]
    status, emb = api.handle("GET", "/sdapi/v1/embeddings", None)
    assert status == 200 and emb["loaded"]["tiemb"]["vectors"] == 2 and not emb["skipped"]
    shutil.copy(os.path.join(network_dirs, "tiemb.safetensors"),
                os.path.join(network_dirs, "second.safetensors"))
    assert api.handle("POST", "/sdapi/v1/refresh-embeddings", {}) == (200, {})
    assert sorted(api.handle("GET", "/sdapi/v1/embeddings", None)[1]["loaded"]) == [
        "second", "tiemb"]
    base = {"steps": 1, "width": 64, "height": 64}
    for prompt, name in (("a <lora:nope:1>", "nope"), ("a <hypernet:nohn>", "nohn")):
        status, out = api.handle("POST", "/sdapi/v1/txt2img", dict(base, prompt=prompt))
        assert status == 404 and name in out["detail"]
    status, out = api.handle("POST", "/sdapi/v1/txt2img", dict(
        base, override_settings={"sd_hypernetwork": "thn"}))
    assert status == 200, out


def test_hires_pass_with_networks(models, f32_policies, network_dirs):
    """With hires fix the first pass's LoRA and hypernetwork stay active and
    the second pass's conds come from the prompt without its tags; an
    hr_prompt with networks of its own raises naming them."""
    _, pm = models
    out = port_proc.process_txt2img(pm, _params(
        prompt="a cat <lora:tlora:1> <hypernet:thn:0.6>", enable_hr=True, hr_scale=1.5,
        denoising_strength=0.5, steps=2, batch_size=1))
    assert out.images[0].shape == (96, 96, 3) and "<lora:tlora:1>" in out.infotexts[0]
    assert port_proc._hires_prompt(_params(prompt="a cat <lora:tlora:1>",
                                           hr_prompt="a dog <lora:tlora:1>")) == "a dog "
    with pytest.raises(NotImplementedError, match="<lora:other:1>"):
        port_proc._hires_prompt(_params(prompt="a cat", hr_prompt="a <lora:other:1>"))
