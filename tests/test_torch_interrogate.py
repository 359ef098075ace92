"""DeepDanbooru, BLIP, the CLIP interrogator and ``/sdapi/v1/interrogate``
in the port against the JAX package (CPU, f32).

The nets are tiny and seeded: DeepDanbooru at a reduced plan
(``TINY_PLAN`` of ``test_torch_preprocess``), BLIP and CLIP as
``transformers`` models of two layers 32 wide (the layouts the JAX
package's converters read).  Bounds: DeepDanbooru's scores within 1e-4 and
``tag_image`` strings equal under every tag option; BLIP's encoder states
and logits within 1e-4 of the largest magnitude, its greedy and beam ids
equal; the interrogator's features within 1e-5 and its strings equal,
ranks included; the route's answers equal to JAX's handler's.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import base64
import dataclasses
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.models import blip as jax_blip
from sdwebui_tpu.models import deepbooru as jax_db
from sdwebui_tpu.postprocessing import interrogate as jax_int
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.models import blip as port_blip
from sdwebui_tpu_torch.models import deepbooru as port_db
from sdwebui_tpu_torch.postprocessing import interrogate as port_int
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import encode_png
from test_torch_preprocess import TINY_PLAN, tiny_booru  # noqa: F401

transformers = pytest.importorskip("transformers")

TAGS = ["red_fox", "rating:safe", "cat_(animal)", "blue", "big_dog"]


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _image(seed: int, h: int = 48, w: int = 40) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture
def both_opts():
    saved = []

    def set_(**kw):
        for o in (opts, jax_opts):
            saved.append((o, {k: o.data.get(k) for k in kw}))
            o.data.update(kw)

    yield set_
    for o, old in reversed(saved):
        o.data.update(old)


# --------------------------------------------------------------------------
# DeepDanbooru
# --------------------------------------------------------------------------

def test_deepbooru_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_db, "_PLAN", list(TINY_PLAN))      # JAX's tag_image takes no plan
    sd = port_db.random_state_dict(TAGS, seed=1, plan=TINY_PLAN, stem=4)
    params, _ = jax_db.convert_deepbooru({k: v.numpy() for k, v in sd.items() if k != "tags"},
                                         plan=TINY_PLAN)
    net = port_db.convert_deepbooru(sd, plan=TINY_PLAN)
    assert net.tags == TAGS
    x = np.random.default_rng(2).random((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax_db.apply(params, jnp.asarray(x), plan=TINY_PLAN))
    with torch.no_grad():
        out = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert _rel(out, ref) <= 1e-4
    back = port_db.deepbooru_from_jax(params, TAGS, TINY_PLAN)
    with torch.no_grad():
        assert _rel(back(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy(), ref) <= 1e-4
    img = _image(3)
    scores = port_db.scores(net, img)
    for threshold in (float(np.median(scores)), 0.0):
        for kw in ({}, {"alpha_sort": True}, {"use_spaces": False, "use_escape": False},
                   {"filter_tags": "blue, big dog"}, {"include_ranks": True}):
            assert port_db.tag_image(net, img, threshold, **kw) == \
                jax_db.tag_image(params, TAGS, Image.fromarray(img), threshold, **kw)
    assert "rating" not in port_db.tag_image(net, img, 0.0)
    assert port_db.tag_image(net, img, 0.0, use_spaces=False).count("\\(") == 1


def test_deepbooru_checks_shapes_and_reads_tags(tmp_path):
    sd = port_db.random_state_dict(TAGS, seed=1, plan=TINY_PLAN, stem=4)
    with pytest.raises(AssertionError, match="unexpected stem"):
        port_db.convert_deepbooru(sd)
    wrong = dict(sd)
    wrong["n_Conv_1.weight"] = torch.zeros(8, 4, 1, 1)
    with pytest.raises(AssertionError):
        port_db.convert_deepbooru(wrong, plan=TINY_PLAN)
    torch.save(sd, tmp_path / "with.pt")
    assert port_db.load_deepbooru(str(tmp_path / "with.pt"), "cpu", TINY_PLAN).tags == TAGS
    torch.save({k: v for k, v in sd.items() if k != "tags"}, tmp_path / "side.pt")
    (tmp_path / "side.tags.txt").write_text("x\ny\n")
    assert port_db.load_deepbooru(str(tmp_path / "side.pt"), "cpu", TINY_PLAN).tags == ["x", "y"]
    full = port_db.plan_convs(port_db.PLAN, 64, 10)
    assert len(full) == 179 and full[-1] == (178, 4096, 10, 1, False)


# --------------------------------------------------------------------------
# BLIP
# --------------------------------------------------------------------------

def _tiny_blip(vocab: int = 100, bos: int = 2, sep: int = 3) -> dict:
    from transformers import (BlipConfig, BlipForConditionalGeneration, BlipTextConfig,
                              BlipVisionConfig)

    torch.manual_seed(0)
    cfg = BlipConfig(
        vision_config=BlipVisionConfig(hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=2, num_attention_heads=2,
                                       image_size=32, patch_size=8).to_dict(),
        text_config=BlipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=2, encoder_hidden_size=32,
                                   vocab_size=vocab, bos_token_id=bos, sep_token_id=sep,
                                   eos_token_id=sep, pad_token_id=0).to_dict())
    model = BlipForConditionalGeneration(cfg).eval()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def blip_pair():
    sd = _tiny_blip()
    tree, cfg = jax_blip.convert_blip({k: v.numpy() for k, v in sd.items()})
    cfg = dataclasses.replace(cfg, bos_token_id=2, sep_token_id=3)
    net = port_blip.convert_blip(sd)
    net.cfg = dataclasses.replace(net.cfg, bos_token_id=2, sep_token_id=3)
    return tree, cfg, net


def test_blip_logits_match_jax(blip_pair):
    tree, cfg, net = blip_pair
    assert dataclasses.asdict(net.cfg) == dataclasses.asdict(cfg)
    pixels = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    enc_ref = np.asarray(jax_blip.vision_apply(tree, cfg, jnp.asarray(pixels)))
    with torch.no_grad():
        enc = net.vision(torch.from_numpy(pixels.transpose(0, 3, 1, 2).copy()))
    assert _rel(enc.numpy(), enc_ref) <= 1e-4
    ids = np.array([[2, 5, 9, 7], [2, 11, 3, 0]], np.int32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.int32)
    ref = np.asarray(jax_blip.decoder_logits(tree, cfg, jnp.asarray(ids), jnp.asarray(enc_ref),
                                             attn_mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = net.decoder_logits(torch.from_numpy(ids.astype(np.int64)),
                                 torch.from_numpy(enc_ref), torch.from_numpy(mask))
    assert _rel(out.numpy(), ref) <= 1e-4
    back = port_blip.blip_from_jax(tree, cfg)
    with torch.no_grad():
        assert _rel(back.vision(torch.from_numpy(pixels.transpose(0, 3, 1, 2).copy())).numpy(),
                    enc_ref) <= 1e-4


@pytest.mark.parametrize("beams,min_new", [(1, 0), (1, 3), (2, 0), (3, 3)])
def test_blip_generate_matches_jax(blip_pair, beams, min_new):
    tree, cfg, net = blip_pair
    pixels = np.random.default_rng(beams + min_new).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    ref = jax_blip.generate(tree, cfg, jnp.asarray(pixels), [2], max_new_tokens=4,
                            min_new_tokens=min_new, num_beams=beams)
    out = net.generate(torch.from_numpy(pixels.transpose(0, 3, 1, 2).copy()), [2],
                       max_new_tokens=4, min_new_tokens=min_new, num_beams=beams)
    np.testing.assert_array_equal(out, ref)


def test_blip_layouts_preprocess_and_wordpiece(tmp_path):
    sd = _tiny_blip()
    renames = (("vision_model.embeddings.class_embedding", "visual_encoder.cls_token"),
               ("vision_model.embeddings.position_embedding", "visual_encoder.pos_embed"),
               ("vision_model.embeddings.patch_embedding.", "visual_encoder.patch_embed.proj."),
               ("vision_model.post_layernorm.", "visual_encoder.norm."),
               ("vision_model.encoder.layers.", "visual_encoder.blocks."),
               (".layer_norm1.", ".norm1."), (".layer_norm2.", ".norm2."),
               (".self_attn.qkv.", ".attn.qkv."), (".self_attn.projection.", ".attn.proj."))
    original = {}
    for k, v in sd.items():
        if k.startswith("vision_model."):
            for old, new in renames:
                k = k.replace(old, new)
        original[k] = v
    a, b = port_blip.convert_blip(sd), port_blip.convert_blip(original)
    assert a.cfg == b.cfg and a.cfg.image_size == 32 and a.cfg.vocab_size == 100
    assert sorted(a.sd) == sorted(b.sd)
    img = _image(4, 50, 70)
    np.testing.assert_allclose(port_blip.preprocess(img, 32).transpose(0, 2, 3, 1),
                               jax_blip.preprocess(Image.fromarray(img), 32), rtol=0, atol=1e-6)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "picture", "of", "cat", "##s", "dog"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    ours, theirs = port_blip.WordPiece(str(tmp_path / "vocab.txt")), \
        jax_blip.WordPiece(str(tmp_path / "vocab.txt"))
    for text in ("a picture of cats", "A DOG of zebras", ""):
        assert ours.encode(text) == theirs.encode(text)
        assert ours.decode(ours.encode(text) + [3]) == theirs.decode(theirs.encode(text) + [3])


# --------------------------------------------------------------------------
# the CLIP interrogator
# --------------------------------------------------------------------------

def _tiny_clip() -> dict:
    from transformers import CLIPConfig, CLIPModel

    torch.manual_seed(1)
    cfg = CLIPConfig(
        text_config=dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=2, vocab_size=49408, max_position_embeddings=77,
                         hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8,
                           hidden_act="quick_gelu"),
        projection_dim=16)
    return {k: v.detach().clone() for k, v in CLIPModel(cfg).eval().state_dict().items()}


def _write_blip_files(directory):
    """A BLIP file whose config the converter derives (BERT's special
    ids in a 30524-id vocabulary) and its vocab.txt."""
    directory.mkdir(parents=True)
    write_safetensors(str(directory / "blip.safetensors"),
                      _tiny_blip(vocab=30524, bos=30522, sep=102))
    vocab = [f"w{i}" for i in range(30524)]
    for i, t in ((0, "[PAD]"), (100, "[UNK]"), (101, "[CLS]"), (102, "[SEP]"),
                 (1037, "a"), (3861, "picture"), (1997, "of"), (30522, "[DEC]"),
                 (30523, "[ENC]")):
        vocab[i] = t
    (directory / "vocab.txt").write_text("\n".join(vocab))


@pytest.fixture
def interrogate_files(tmp_path, tiny_booru):  # noqa: F811
    """The reference's layout under tmp_path: DeepDanbooru (tiny_booru's),
    a CLIP model, two category files, BLIP."""
    (tmp_path / "models").mkdir(exist_ok=True)
    os.symlink(tiny_booru, tmp_path / "models" / "torch_deepdanbooru")
    (tmp_path / "models" / "clip_vision").mkdir()
    write_safetensors(str(tmp_path / "models" / "clip_vision" / "clip.safetensors"),
                      _tiny_clip())
    (tmp_path / "interrogate").mkdir()
    (tmp_path / "interrogate" / "artists.txt").write_text("a painter\nb sculptor\nc potter\n")
    (tmp_path / "interrogate" / "flavors.top3.txt").write_text(
        "\n".join(f"flavor {i}" for i in range(8)))
    _write_blip_files(tmp_path / "models" / "BLIP")
    return tmp_path


def test_clip_interrogator_matches_jax(interrogate_files, both_opts):
    root = interrogate_files
    path = str(root / "models" / "clip_vision" / "clip.safetensors")
    ref = jax_int.ClipInterrogator(path, str(root / "interrogate"))
    out = port_int.ClipInterrogator(path, str(root / "interrogate"), device="cpu")
    assert out.categories == port_int.load_categories(str(root / "interrogate")) == \
        jax_int.load_categories(str(root / "interrogate"))
    img = _image(6, 60, 44)
    assert _rel(out.image_features(img), np.asarray(ref.image_features(Image.fromarray(img)))) \
        <= 1e-5
    texts = ["a painter", "flavor 3"]
    assert _rel(out.text_features(texts), np.asarray(ref.text_features(texts))) <= 1e-5
    for kw in ({}, {"interrogate_return_ranks": True},
               {"interrogate_clip_skip_categories": ["artists"], "interrogate_clip_dict_limit": 4}):
        both_opts(**kw)
        assert out.interrogate(img) == ref.interrogate(Image.fromarray(img))
    both_opts(interrogate_clip_max_length=6, interrogate_clip_min_length=2,
              interrogate_clip_num_beams=2)
    blip_dir = root / "models" / "BLIP"
    found = port_int.find_blip_model(str(blip_dir))
    assert found == jax_int.find_blip_model(str(blip_dir))
    caption = port_int.BlipCaptioner(*found, device="cpu")
    ref_caption = jax_int.BlipCaptioner(*found)
    assert caption.caption(img) == ref_caption.caption(Image.fromarray(img))
    assert out.interrogate(img, captioner=caption) == \
        ref.interrogate(Image.fromarray(img), captioner=ref_caption)


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------

def _jax_interrogate():
    fake = types.SimpleNamespace()
    fake._interrogate_inner = lambda body: jax_api.Api._interrogate_inner(fake, body)
    return lambda body: jax_api.Api.interrogate(fake, body), fake


def test_interrogate_route_matches_jax(interrogate_files, monkeypatch, both_opts):
    monkeypatch.chdir(interrogate_files)
    both_opts(interrogate_clip_max_length=5, interrogate_clip_min_length=2,
              interrogate_deepbooru_score_threshold=0.4)
    api = Api(Engine(device="cpu", tiny=True))
    png = base64.b64encode(encode_png(_image(8, 40, 56))).decode()
    jax_route, fake = _jax_interrogate()
    for model in ("deepdanbooru", "clip"):
        body = {"image": png, "model": model}
        status, got = api.handle("POST", "/sdapi/v1/interrogate", body)
        assert (status, got) == (200, jax_route(body))
        assert got["caption"]
        assert api._interrogators == {} and not hasattr(fake, "_deepbooru")
    both_opts(interrogate_keep_models_in_memory=True)
    api.handle("POST", "/sdapi/v1/interrogate", {"image": png, "model": "clip"})
    assert sorted(api._interrogators) == ["blip", "clip"]
    # without the CLIP model: BLIP's caption alone, as JAX answers
    os.remove("models/clip_vision/clip.safetensors")
    body = {"image": png, "model": "clip"}
    api._interrogators.clear()
    assert api.handle("POST", "/sdapi/v1/interrogate", body) == (200, jax_route(body))
    assert api.handle("POST", "/sdapi/v1/interrogate", {"model": "clip"})[0] == 404
    assert api.handle("POST", "/sdapi/v1/interrogate", {"image": png, "x": 1})[0] == 422


def test_interrogate_route_answers_501_without_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    api = Api(Engine(device="cpu", tiny=True))
    png = base64.b64encode(encode_png(_image(9))).decode()
    jax_route, _ = _jax_interrogate()
    for model in ("deepdanbooru", "clip", "other"):
        status, got = api.handle("POST", "/sdapi/v1/interrogate", {"image": png, "model": model})
        with pytest.raises(jax_api.ApiError) as e:
            jax_route({"image": png, "model": model})
        assert (status, got["detail"]) == (e.value.status, e.value.message) \
            and status == 501 and repr(model) in got["detail"]
