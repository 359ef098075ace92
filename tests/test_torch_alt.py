"""AltDiffusion in the port against the JAX package (CPU, f32).

XLM-R (its converter's config, the forward with padding to 1e-4, the m18
variant's penultimate projection), the AltConditioner with a SentencePiece
tokenizer written from a synthetic vocab, the tokenizer wrappers of the
port's ``sentencepiece`` copy (and its JSON reader of an HF Unigram
``tokenizer.json`` against the JAX package's ``tokenizers`` path), and a
tiny AltDiffusion txt2img within 1 uint8 level of JAX's with the same
infotext.  The checkpoint: the JAX suite's tiny SD1 (``tests/test_loader``)
with its text encoder replaced by a random XLM-R and projection, read by
both packages' loaders from one ``.safetensors``.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.loader import load as jax_load
from sdwebui_tpu.models import xlmr as jax_xlmr
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.text import sentencepiece as jax_spm
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.loader import load, safetensors_io
from sdwebui_tpu_torch.models import xlmr
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.text import sentencepiece as spm
from sdwebui_tpu_torch.utils import devices as port_devices
from test_loader import _tiny_ldm_state_dict
from test_sentencepiece import VOCAB, _model_proto
from test_torch_models import _assert_rel

TINY = xlmr.XLMRConfig(vocab_size=120, hidden=64, layers=2, heads=4, intermediate=128,
                       project_dim=64)
PROMPTS = ["the cat on the mat", "", "a cat", "tHe  CAT\ton   the mat", "ünïcödé cat"]


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


def _xlmr_state_dict(cfg=TINY, seed=0, positions=90, prefix="cond_stage_model."):
    """A random XLM-R checkpoint (its biases and norm gains jittered)."""
    m = xlmr.XLMRModel(cfg, device="cpu", dtype=torch.float32, positions=positions)
    gen = torch.Generator().manual_seed(seed)
    from sdwebui_tpu_torch.models.layers import reset_random

    reset_random(m, gen)
    sd = {}
    for k, v in m.state_dict().items():
        if v.dim() == 1:
            v = v + 0.1 * torch.randn(v.shape, generator=gen)
        sd[prefix + k] = v.clone()
    sd[prefix + "roberta.embeddings.position_ids"] = torch.arange(positions)[None]  # dropped
    return sd


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("xlmr") / "sentencepiece.bpe.model"
    path.write_bytes(_model_proto(VOCAB))
    return str(path)


@pytest.mark.parametrize("m18", [False, True])
def test_xlmr_forward_matches_jax(m18):
    """Padded rows (the mask counts positions past the pad id): 1e-4."""
    cfg = dataclasses.replace(TINY, pre_transformation=m18)
    sd = _xlmr_state_dict(cfg, seed=int(m18))
    flat, port_cfg, positions = xlmr.convert_xlmr(sd)
    tree, jcfg = jax_xlmr.convert_xlmr({k: v.numpy() for k, v in sd.items()})
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jcfg) and positions == 90
    port = xlmr.xlmr_from_jax(tree, jcfg)
    ids = np.array([[0, 17, 62, 9, 2, 1, 1, 1], [0, 44, 7, 95, 31, 10, 3, 2]], np.int32)
    ref = np.asarray(jax_xlmr.apply(tree, jcfg, jnp.asarray(ids)))
    with torch.no_grad():
        out = port(torch.from_numpy(ids.astype(np.int64))).numpy()
    _assert_rel(out, ref, 1e-4)


def test_alt_conditioner_matches_jax(vocab):
    sd = _xlmr_state_dict(seed=4)
    tree, jcfg = jax_xlmr.convert_xlmr({k: v.numpy() for k, v in sd.items()})
    jc = jax_xlmr.AltConditioner(tree, jcfg, jax_spm.make_xlmr_tokenizer(vocab))
    pc = xlmr.AltConditioner(xlmr.xlmr_from_jax(tree, jcfg), TINY,
                             spm.make_xlmr_tokenizer(vocab))
    ref, _ = jc.encode(PROMPTS)
    out, pooled = pc.encode(PROMPTS)
    assert pooled is None and tuple(out.shape) == (len(PROMPTS), 77, 64)
    _assert_rel(out.numpy(), np.asarray(ref), 1e-4)
    with pytest.raises(RuntimeError, match="tokenizer"):
        xlmr.AltConditioner(pc.model, TINY).encode(["a cat"])


@pytest.mark.parametrize("make", ["t5", "xlmr"])
def test_tokenizer_wrappers_equal_jax(vocab, make):
    ours = getattr(spm, f"make_{make}_tokenizer")(vocab)
    ref = getattr(jax_spm, f"make_{make}_tokenizer")(vocab)
    for text in PROMPTS:
        assert ours(text) == ref(text)


def _hf_unigram_json(path):
    """An HF tokenizer.json of VOCAB's Unigram model (what transformers
    writes for T5: pad, eos and unk as special tokens)."""
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]] + \
        [[t, s] for t, s, typ in VOCAB if typ == spm.NORMAL]
    spec = {"version": "1.0", "added_tokens": [
        {"id": i, "content": t, "special": True, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False} for i, (t, _) in enumerate(vocab[:3])],
        "normalizer": None,
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                          "split": True},
        "post_processor": None,
        "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                    "split": True},
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f)


def test_tokenizer_json_reads_the_unigram_vocab(tmp_path):
    """The port reads an HF Unigram tokenizer.json with json alone: T5's
    ids equal the JAX package's (read through the tokenizers wheel); an
    XLM-R or non-Unigram tokenizer.json raises naming the file."""
    path = str(tmp_path / "tokenizer.json")
    _hf_unigram_json(path)
    ours, ref = spm.make_t5_tokenizer(path), jax_spm.make_t5_tokenizer(path)
    for text in ("the cat on the mat", "a cat", "cat the"):
        assert ours(text) == ref(text)
    with pytest.raises(NotImplementedError, match="tokenizer.json"):
        spm.make_xlmr_tokenizer(path)
    bpe = str(tmp_path / "bpe" / "tokenizer.json")
    (tmp_path / "bpe").mkdir()
    with open(bpe, "w") as f:
        json.dump({"model": {"type": "BPE", "vocab": {}, "merges": []}}, f)
    with pytest.raises(NotImplementedError, match="bpe"):
        spm.load_sentencepiece(bpe)
    assert load.find_spm_tokenizer(str(tmp_path / "nothing-here")) is None
    assert load.find_spm_tokenizer(str(tmp_path), make="t5")("a cat") == ref("a cat")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    _, sd = _tiny_ldm_state_dict()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()
          if not k.startswith("cond_stage_model.")}
    sd.update(_xlmr_state_dict(seed=7))
    path = str(tmp_path_factory.mktemp("alt") / "alt-tiny.safetensors")
    safetensors_io.write_safetensors(path, sd)
    return path


@pytest.fixture(scope="module")
def models(checkpoint, vocab):
    """(JAX model, the port's from its file, the port's from_jax of JAX's),
    the port's tokenizer found through set_tokenizer_dir."""
    import os

    prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    load.set_tokenizer_dir("xlmr", os.path.dirname(vocab))
    try:
        jm = jax_load.load_model(checkpoint)
        pm = load.load_model(checkpoint, device="cpu")
    finally:
        load.set_tokenizer_dir("xlmr", None)
        jax_devices.set_policy(prev[0])
        port_devices.set_policy(prev[1])
    jm.conditioner.tokenizer = jax_spm.make_xlmr_tokenizer(vocab)
    return jm, pm, port_sd.from_jax(jm)


def test_from_jax_consumes_every_key(models):
    from sdwebui_tpu.utils.pytree import flatten

    jm, pm, pj = models
    assert pm.kind == pj.kind == "alt" and pm.conditioner.tokenizer is not None
    assert set(pj.conditioner.model.state_dict()) == set(flatten(jm.conditioner.params))
    assert pm.conditioner.cfg == pj.conditioner.cfg
    for k, v in pm.conditioner.model.state_dict().items():
        torch.testing.assert_close(v, pj.conditioner.model.state_dict()[k], rtol=0, atol=0)


@pytest.mark.parametrize("which", ["file", "from_jax"])
def test_alt_txt2img_matches_jax(models, f32_policies, which):
    jm, pm, pj = models
    base = dict(prompt="a cat on the mat", negative_prompt="the", seed=29, steps=4,
                width=64, height=64, cfg_scale=7.0, sampler_name="Euler a",
                override_settings={"sdtpu_vae_bf16": False})
    ref = jax_proc.process_txt2img(jm, JaxParams(**base))
    out = port_proc.process_txt2img(pm if which == "file" else pj, GenerationParams(**base))
    a, b = out.images[0], np.asarray(ref.images[0])
    assert a.shape == b.shape == (64, 64, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts
