"""The port's copies of the JAX package's host modules stay equal to their
sources: the Philox stream and the seeded image noise, every option key and
default, every config field, the prompt parser and tokenizer on a fixed
corpus, infotext round-trips, the generation params, the pytree helpers,
the checkpoint sniffer, every sigma schedule under the options that reshape
it, LCM's distillation subtable, and the tables of the hires and upscale
path (latent upscale modes, the Extras stage fields, the built-in
upscalers, ESRGAN's old-key map and architecture sniffing), the prompt
styles' CSV database, outpainting mk2's noise fill, the saving path's
host code (the filename patterns, the writer thread, the EXIF comment
reader, log.csv), the web UI's page, the start-up timer, the console line
and the parts of the extensions manager, config states and compat shim
that are JAX's.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses

import numpy as np
import pytest

from sdwebui_tpu.loader import sniff as jax_sniff
from sdwebui_tpu.models import esrgan as jax_esrgan
from sdwebui_tpu.models import configs as jax_configs
from sdwebui_tpu.pipeline import params as jax_params
from sdwebui_tpu.pipeline import processing as jax_processing
from sdwebui_tpu.postprocessing import stages as jax_stages
from sdwebui_tpu.postprocessing import upscalers as jax_upscalers
from sdwebui_tpu.rng import image_rng as jax_image_rng
from sdwebui_tpu.rng import philox as jax_philox
from sdwebui_tpu.sampling import discretization as jax_disc
from sdwebui_tpu.sampling import schedulers as jax_sched
from sdwebui_tpu.text import prompt_parser as jax_pp
from sdwebui_tpu.text import styles as jax_styles
from sdwebui_tpu.text import tokenizer as jax_tok
from sdwebui_tpu.utils import infotext as jax_infotext
from sdwebui_tpu.utils import options as jax_options
from sdwebui_tpu.utils import pytree as jax_pytree
from sdwebui_tpu_torch.loader import sniff
from sdwebui_tpu_torch.models import configs, esrgan
from sdwebui_tpu_torch.pipeline import params, processing
from sdwebui_tpu_torch.postprocessing import stages, upscalers
from sdwebui_tpu_torch.rng import image_rng, philox
from sdwebui_tpu_torch.sampling import discretization, schedulers
from sdwebui_tpu_torch.text import prompt_parser as pp
from sdwebui_tpu_torch.text import styles
from sdwebui_tpu_torch.text import tokenizer as tok
from sdwebui_tpu_torch.utils import infotext, options, pytree

PROMPTS = [
    "a (red:1.2) cat [in the snow:on a hill:0.5] AND a castle :0.7",
    "masterpiece, ((best quality)), [blurry|sharp] photo of a dog BREAK city at night",
    "[cat:dog:3] [:tree:0.25] [bird::0.8] \\(literal\\) (nested (weights:1.5):0.8)",
    "# a comment line\nline two, with, commas # and a trailing comment",
    "a [broken | prompt",
    "",
]


def test_philox_golden_and_streams():
    assert philox.PhiloxGenerator(0).randn((3, 4))[0, 0] == np.float32(-0.9246624)
    for seed in (0, 1234, 2 ** 32 - 1):
        a, b = philox.PhiloxGenerator(seed), jax_philox.PhiloxGenerator(seed)
        np.testing.assert_array_equal(a.randn((4, 8, 8)), b.randn((4, 8, 8)))
        np.testing.assert_array_equal(a.randn_batch(3, (2, 5)), b.randn_batch(3, (2, 5)))
    # a draw above the JAX package's native-path threshold (2**18 values)
    offs = np.arange(5, dtype=np.uint32)
    np.testing.assert_array_equal(philox.randn_at(7, offs, 64 * 1024),
                                  jax_philox.randn_at(7, offs, 64 * 1024))


@pytest.mark.parametrize("gen", ["PhiloxGenerator", "TorchCPUGenerator"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(subseeds=[9, 10], subseed_strength=0.4),
    dict(seed_resize_from_h=48, seed_resize_from_w=80),
    dict(eta_noise_seed_delta=31337),
])
def test_image_rng_matches_jax(gen, kw):
    port_cls = getattr(philox if gen == "PhiloxGenerator" else image_rng, gen)
    jax_cls = getattr(jax_philox if gen == "PhiloxGenerator" else jax_image_rng, gen)
    a = image_rng.ImageRNG((4, 8, 8), [3, 4], channels_last=False, gen_cls=port_cls, **kw)
    b = jax_image_rng.ImageRNG((4, 8, 8), [3, 4], channels_last=False, gen_cls=jax_cls, **kw)
    np.testing.assert_array_equal(a.first(), b.first())
    np.testing.assert_array_equal(a.next_k(3), b.next_k(3))
    np.testing.assert_array_equal(a.next(), b.next())


def test_create_rng_sources():
    a = image_rng.create_rng((4, 8, 8), [5], subseeds=[6], subseed_strength=0.3)
    b = jax_image_rng.create_rng((4, 8, 8), [5], subseeds=[6], subseed_strength=0.3)
    np.testing.assert_array_equal(a.first(), b.first())
    np.testing.assert_array_equal(a.next_k(2), b.next_k(2))
    with options.opts.override({"randn_source": "GPU"}):
        from sdwebui_tpu.utils import options as jax_opts

        with jax_opts.opts.override({"randn_source": "GPU"}):
            a = image_rng.create_rng((4, 8, 8), [5], subseeds=[6], subseed_strength=0.3,
                                     channels_last=False)
            b = jax_image_rng.create_rng((4, 8, 8), [5], subseeds=[6], subseed_strength=0.3)
        # the device source: XLA's CPU f32 sin is up to 1.5e-6 off (ROADMAP C)
        np.testing.assert_allclose(a.first().numpy(),
                                   np.moveaxis(np.asarray(b.first()), -1, -3), atol=2e-6)
        np.testing.assert_allclose(a.next_k(2).numpy(),
                                   np.moveaxis(np.asarray(b.next_k(2)), -1, -3), atol=2e-6)


def test_every_option_key_and_default():
    ours, theirs = options.make_default_templates(), jax_options.make_default_templates()
    assert list(ours) == list(theirs)
    for key in ours:
        assert (ours[key].default, ours[key].label, ours[key].section) == \
            (theirs[key].default, theirs[key].label, theirs[key].section), key
    # the port's opts is its own object, at the defaults
    assert options.opts is not jax_options.opts
    assert options.opts.data == {k: v.default for k, v in ours.items()}


def _fields(cls):
    return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]


def test_every_config_field():
    for name in ("UNetConfig", "VAEConfig", "CLIPTextConfig"):
        assert _fields(getattr(configs, name)) == _fields(getattr(jax_configs, name)), name
    instances = [n for n, v in vars(jax_configs).items() if dataclasses.is_dataclass(v)
                 and not isinstance(v, type)]
    assert len(instances) >= 8
    for n in instances:
        assert dataclasses.asdict(getattr(configs, n)) == \
            dataclasses.asdict(getattr(jax_configs, n)), n
        ours, theirs = getattr(configs, n), getattr(jax_configs, n)
        for prop in ("head_dims", "time_embed_dim"):
            if hasattr(theirs, prop):
                assert getattr(ours, prop) == getattr(theirs, prop), (n, prop)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_prompt_parser_on_a_corpus(prompt):
    assert pp.strip_comments(prompt) == jax_pp.strip_comments(prompt)
    assert pp.parse_prompt_attention(prompt) == jax_pp.parse_prompt_attention(prompt)
    for steps in (1, 10, 20):
        assert pp.get_prompt_schedule(prompt, steps) == jax_pp.get_prompt_schedule(prompt, steps)
        assert pp.get_prompt_schedule(prompt, steps, 30, True) == \
            jax_pp.get_prompt_schedule(prompt, steps, 30, True)
    ours, theirs = pp.split_multicond(prompt), jax_pp.split_multicond(prompt)
    assert [(s.text, s.weight) for s in ours] == [(s.text, s.weight) for s in theirs]


def test_tokenizers_on_a_corpus():
    assert (tok.BOS, tok.EOS, tok.COMMA, tok.VOCAB_SIZE) == \
        (jax_tok.BOS, jax_tok.EOS, jax_tok.COMMA, jax_tok.VOCAB_SIZE)
    vocab = {}
    for i, piece in enumerate(sorted(set(tok.bytes_to_unicode().values()))):
        vocab[piece] = i
        vocab[piece + "</w>"] = 1000 + i
    merges = [("c", "a"), ("ca", "t</w>"), ("d", "o"), ("do", "g</w>"), ("t", "h")]
    vocab.update({"ca": 3000, "cat</w>": 3001, "do": 3002, "dog</w>": 3003, "th": 3004})
    pairs = [(tok.FallbackTokenizer(), jax_tok.FallbackTokenizer()),
             (tok.ClipBPETokenizer(vocab, merges), jax_tok.ClipBPETokenizer(vocab, merges))]
    for ours, theirs in pairs:
        for prompt in PROMPTS + ["Ünïcode cat &amp; dog's   spaces, the END"]:
            assert ours.encode(prompt) == theirs.encode(prompt)


def test_infotext_round_trips():
    pairs = {"Steps": 20, "Sampler": "Euler a", "CFG scale": 7.5, "Seed": 1234,
             "Size": "512x512", "Model": "a, b: c", "Denoising strength": 0.75,
             "Version": "sdwebui-tpu-0.1.0", "Note": 'say "hi", there'}
    for prompt, negative in (("a cat", "blurry"), ("line one\nline two", ""), ("", "x")):
        text = infotext.build(prompt, negative, pairs)
        assert text == jax_infotext.build(prompt, negative, pairs)
        assert infotext.parse(text) == jax_infotext.parse(text)
        assert infotext.parse(text)["Prompt"] == prompt
    for text in ("sdwebui-tpu-0.1.0", "v1.10.1", "nonsense"):
        assert infotext.parse_version(text) == jax_infotext.parse_version(text)


def test_params_and_pytree():
    assert _fields(params.GenerationParams) == _fields(jax_params.GenerationParams)
    assert _fields(params.Processed) == _fields(jax_params.Processed)
    kw = dict(prompt="p", seed=3, steps=4, width=64, height=96)
    res = [mod.Processed(images=[], params=mod.GenerationParams(**kw), seed=3, subseed=4,
                         infotexts=["i"], all_seeds=[3], all_subseeds=[4], all_prompts=["p"])
           for mod in (params, jax_params)]
    assert res[0].js() == res[1].js()
    assert params.GenerationParams(**kw).latent_size() == (12, 8)
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert pytree.flatten(tree) == jax_pytree.flatten(tree) == {"a.b": 1, "a.c.d": 2, "e": 3}
    assert pytree.unflatten(pytree.flatten(tree)) == tree


_UNET = "model.diffusion_model.input_blocks.0.0.weight"
_SNIFF_CASES = [
    {_UNET: np.zeros((320, 4, 3, 3))},
    {_UNET: np.zeros((320, 9, 3, 3)),
     "cond_stage_model.model.transformer.resblocks.0.attn.in_proj_weight": np.zeros(1)},
    {_UNET: np.zeros((320, 5, 3, 3)), "depth_model.model.x": np.zeros(1),
     "cond_stage_model.model.transformer.resblocks.0.attn.in_proj_weight": np.zeros(1)},
    {_UNET: np.zeros((320, 4, 3, 3)), "noise_augmentor.data_mean": np.zeros(1)},
    {_UNET: np.zeros((320, 4, 3, 3)), "conditioner.embedders.1.model.ln_final.weight": 0},
    {_UNET: np.zeros((384, 4, 3, 3)), "conditioner.embedders.0.model.ln_final.weight": 0},
    {_UNET: np.zeros((320, 4, 3, 3)),
     "cond_stage_model.roberta.embeddings.word_embeddings.weight": 0},
    {"model.diffusion_model.x_embedder.proj.weight": np.zeros(1)},
]


@pytest.mark.parametrize("case", range(len(_SNIFF_CASES)))
def test_sniff_equals_jax(case):
    sd = _SNIFF_CASES[case]
    assert dataclasses.asdict(sniff.sniff(sd)) == dataclasses.asdict(jax_sniff.sniff(sd))
    with pytest.raises(ValueError):
        sniff.sniff({"random.key": np.zeros(1)})


@pytest.mark.parametrize("opts_override", [
    {}, {"ddim_discretize": "quad"}, {"sigma_min": 0.05, "sigma_max": 10.0, "rho": 5.0}])
def test_every_schedule_equals_jax(opts_override):
    disc_p = discretization.Discretization(discretization.make_alphas_cumprod())
    disc_j = jax_disc.Discretization(jax_disc.make_alphas_cumprod())
    with options.opts.override(opts_override), jax_options.opts.override(opts_override):
        for name in schedulers.SCHEDULERS:
            for n in (1, 3, 8, 20):
                for sdxl in (False, True):
                    np.testing.assert_array_equal(
                        schedulers.get_schedule(name, n, disc_p, is_sdxl=sdxl),
                        jax_sched.get_schedule(name, n, disc_j, is_sdxl=sdxl), err_msg=name)
    assert schedulers.ALIASES == jax_sched.ALIASES
    assert list(schedulers.SCHEDULERS) == list(jax_sched.SCHEDULERS)


def test_lcm_subtable_equals_jax():
    ac = discretization.make_alphas_cumprod()
    disc_p, disc_j = discretization.Discretization(ac), jax_disc.Discretization(ac)
    for a, b in zip(discretization.lcm_subtable(disc_p), jax_disc.lcm_subtable(disc_j)):
        np.testing.assert_array_equal(a, b)
    for n in (1, 4, 8, 50):
        np.testing.assert_array_equal(discretization.lcm_schedule(disc_p, n),
                                      jax_disc.lcm_schedule(disc_j, n))


def test_hires_and_upscaler_tables_equal_jax():
    assert processing.LATENT_UPSCALE_MODES == jax_processing.LATENT_UPSCALE_MODES
    assert _fields(stages.StageArgs) == _fields(jax_stages.StageArgs)
    assert list(stages.STAGES) == list(jax_stages.STAGES)
    assert list(upscalers._REGISTRY)[:3] == list(jax_upscalers._REGISTRY)[:3] == \
        list(upscalers.BUILTIN)
    assert [(e.name, e.default_scale) for e in list(upscalers._REGISTRY.values())[:3]] == \
        [(e.name, e.default_scale) for e in list(jax_upscalers._REGISTRY.values())[:3]]
    assert esrgan._OLD_FIXED == jax_esrgan._OLD_FIXED
    assert esrgan._OLD_KEY_RE.pattern == jax_esrgan._OLD_KEY_RE.pattern
    old = ["model.0.weight", "model.1.sub.3.RDB2.conv5.0.bias", "model.1.sub.23.weight",
           "model.3.bias", "model.6.weight", "model.8.weight", "model.10.bias", "model.2.x"]
    sd = dict.fromkeys(old, 0)
    assert esrgan.normalize_keys(sd) == jax_esrgan.normalize_keys(sd)
    for keys in (["body.0.weight", "body.1.weight"], ["conv_first.weight", "body.0.rdb1.x"],
                 ["model.0.weight", "body.0.weight"], ["body.0.RDB1.weight"]):
        assert esrgan.is_srvgg(keys) == jax_esrgan.is_srvgg(dict.fromkeys(keys))


STYLE_ROWS = ("name,prompt,negative_prompt\n"
              "painterly,\"{prompt}, oil painting\",photo\n"
              "plain,high detail,\n"
              ",nameless,\n"
              "neg,,\"lowres, {prompt}\"\n")


@pytest.mark.parametrize("prompt,negative,names", [
    ("a cat", "blurry", ["painterly", "plain"]),
    ("", "", ["neg", "missing", "plain"]),
    ("a dog, high detail", "lowres, bad", []),
])
def test_styles_equal_jax(tmp_path, prompt, negative, names):
    """The style database's load, apply, extraction, save and extra-file
    merge give the same results as the JAX package's."""
    path = tmp_path / "styles.csv"
    path.write_text(STYLE_ROWS, encoding="utf-8-sig")
    extra = tmp_path / "extra.csv"
    extra.write_text("name,prompt,negative_prompt\nplain,other,\nmore,more text,\n",
                     encoding="utf-8")
    dbs = [mod.StyleDatabase(str(path)) for mod in (styles, jax_styles)]
    for db in dbs:
        db.load_extra(str(extra))
    ours, theirs = dbs
    assert {k: dataclasses.asdict(v) for k, v in ours.styles.items()} == \
        {k: dataclasses.asdict(v) for k, v in theirs.styles.items()}
    applied = ours.apply(prompt, negative, names)
    assert applied == theirs.apply(prompt, negative, names)
    assert ours.extract_styles_from_prompt(*applied) == \
        theirs.extract_styles_from_prompt(*applied)
    assert ours.get_style_prompts(names) == theirs.get_style_prompts(names)
    ours.path = str(tmp_path / "ours.csv")
    theirs.path = str(tmp_path / "theirs.csv")
    ours.save()
    theirs.save()
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "theirs.csv").read_bytes()


ZOO_CONSTANTS = [   # (port module, JAX module, function, arguments)
    ("swinir", "swinir", "relative_position_index", (8,)),
    ("swinir", "swinir", "relative_position_index", (16,)),
    ("swinir", "swinir", "shift_attn_mask", (48, 64, 8, 4)),
    ("swinir", "swinir", "shift_attn_mask", (192, 192, 16, 8)),
    ("swin2sr", "swin2sr", "cpb_coords_table", (8,)),
    ("hat", "hat", "rpi_oca", (16, 24)),
    ("dat", "dat", "rect_rpi", (8, 32)),
    ("dat", "dat", "rect_rpe_biases", (32, 8)),
    ("dat", "dat", "rect_shift_mask", (64, 96, 8, 32, 4, 16)),
]


@pytest.mark.parametrize("port_mod,jax_mod,fn,args", ZOO_CONSTANTS)
def test_zoo_host_constants_equal_jax(port_mod, jax_mod, fn, args):
    """The upscaler zoo's host constants (window indices, shift masks, the
    SwinV2 CPB inputs, HAT's OCA index, DAT's rectangle tables) are copies."""
    import importlib

    ours = getattr(importlib.import_module(f"sdwebui_tpu_torch.models.{port_mod}"), fn)(*args)
    theirs = getattr(importlib.import_module(f"sdwebui_tpu.models.{jax_mod}"), fn)(*args)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def test_ldsr_schedule_equals_jax():
    from sdwebui_tpu.models import ldsr as jax_ldsr
    from sdwebui_tpu_torch.models import ldsr

    np.testing.assert_array_equal(ldsr.make_alphas(ldsr.LDSRConfig()),
                                  jax_ldsr.make_alphas(jax_ldsr.LDSRConfig()))
    assert [f.name for f in dataclasses.fields(ldsr.LDSRConfig)] == \
        [f.name for f in dataclasses.fields(jax_ldsr.LDSRConfig)]


SPM_SHARED = ("_read_varint", "_iter_fields", "parse_model_proto", "SentencePieceUnigram",
              "make_t5_tokenizer")


@pytest.mark.parametrize("name", SPM_SHARED)
def test_sentencepiece_source_equals_jax(name):
    """The SentencePiece reader is a copy: every shared function and class
    has JAX's source text (the port's tokenizer.json branch and its XLM-R
    guard are its own, held to JAX's behaviour in test_torch_alt)."""
    import inspect

    from sdwebui_tpu.text import sentencepiece as jax_spm
    from sdwebui_tpu_torch.text import sentencepiece as spm

    assert inspect.getsource(getattr(spm, name)) == inspect.getsource(getattr(jax_spm, name))
    assert (spm.NORMAL, spm.UNKNOWN, spm.CONTROL, spm.USER_DEFINED, spm.UNUSED, spm.BYTE) == \
        (jax_spm.NORMAL, jax_spm.UNKNOWN, jax_spm.CONTROL, jax_spm.USER_DEFINED,
         jax_spm.UNUSED, jax_spm.BYTE)


def test_sentencepiece_on_a_corpus(tmp_path):
    from sdwebui_tpu.text import sentencepiece as jax_spm
    from sdwebui_tpu_torch.text import sentencepiece as spm
    from test_sentencepiece import VOCAB, _model_proto

    path = tmp_path / "v.model"
    path.write_bytes(_model_proto(VOCAB))
    ours, theirs = spm.load_sentencepiece(str(path)), jax_spm.load_sentencepiece(str(path))
    for prompt in PROMPTS + ["the cat on the mat", "Ünïcode cat", "  spaced   out  "]:
        assert ours.encode(prompt, add_bos=True, add_eos=True) == \
            theirs.encode(prompt, add_bos=True, add_eos=True)
        assert ours.decode(ours.encode(prompt)) == theirs.decode(theirs.encode(prompt))


def test_noise_match_equals_jax():
    """Outpainting mk2's noise fill is a copy: every function has JAX's
    source text, and matched_noise gives JAX's values."""
    import inspect

    from sdwebui_tpu.postprocessing import noise_match as jax_nm
    from sdwebui_tpu_torch.postprocessing import noise_match as nm

    for name in ("_fft2c", "_ifft2c", "_lowpass_window", "match_histograms_1d", "matched_noise"):
        assert inspect.getsource(getattr(nm, name)) == inspect.getsource(getattr(jax_nm, name))
    rng = np.random.default_rng(6)
    src = rng.random((24, 40, 3))
    mask = np.zeros((24, 40, 3))
    mask[:, :8] = mask[:, -8:] = 1.0
    for q, variation in ((1.0, 0.05), (0.5, 0.3)):
        np.testing.assert_array_equal(nm.matched_noise(src, mask, q, variation),
                                      jax_nm.matched_noise(src, mask, q, variation))


#: (JAX module, port module, names whose source text is the same)
SAVING_SHARED = [
    ("sdwebui_tpu.utils.images", "sdwebui_tpu_torch.utils.saving",
     ("sanitize_filename_part", "_writer_loop", "_enqueue_save", "flush_saves")),
    ("sdwebui_tpu.utils.exif", "sdwebui_tpu_torch.utils.exif", ("decode_user_comment",)),
    ("sdwebui_tpu.server.ui_actions", "sdwebui_tpu_torch.server.ui_actions",
     ("_update_logfile", "save_files_from_json", "_LOG_FIELDS")),
    ("sdwebui_tpu.utils.filename", "sdwebui_tpu_torch.utils.filename",
     ("get_next_sequence_number", "_token", "_SkipToken", "_clean", "_WORD_SPLIT", "_SEGMENT",
      "_TRAILING_ARG")),
]


@pytest.mark.parametrize("jax_mod,port_mod,names", SAVING_SHARED,
                         ids=[m[1].rsplit(".", 1)[1] for m in SAVING_SHARED])
def test_saving_sources_equal_jax(jax_mod, port_mod, names):
    """The saving path's host code is a copy wherever it can be: the same
    source text (or value) as the JAX package's."""
    import importlib
    import inspect

    theirs, ours = importlib.import_module(jax_mod), importlib.import_module(port_mod)
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        if callable(a):
            assert inspect.getsource(a) == inspect.getsource(b), name
        else:
            assert a == b, name


def test_filename_generator_is_a_copy():
    """Every FilenameGenerator method but the three that import the port's
    own modules ([scheduler], [prompt_no_styles]) or read the request's VAE
    file ([vae_filename]) has JAX's source text; both register the same
    tokens."""
    import inspect

    from sdwebui_tpu.utils import filename as jax_fn
    from sdwebui_tpu_torch.utils import filename as fn

    assert list(fn._TOKENS) == list(jax_fn._TOKENS)
    own = {"_scheduler_text", "_prompt_no_styles", "_vae_filename"}
    for name, member in vars(jax_fn.FilenameGenerator).items():
        if not inspect.isfunction(getattr(member, "__func__", member)) or name in own:
            continue
        ours = vars(fn.FilenameGenerator)[name]
        assert inspect.getsource(getattr(ours, "__func__", ours)) == \
            inspect.getsource(getattr(member, "__func__", member)), name


def test_web_ui_page_is_a_copy():
    """The page GET / serves is JAX's, after its one header comment."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "sdwebui_tpu", "server", "webui.html"), encoding="utf-8") as f:
        theirs = f.read()
    with open(os.path.join(root, "sdwebui_tpu_torch", "server", "webui.html"),
              encoding="utf-8") as f:
        ours = f.read()
    doctype, rest = ours.split("\n", 1)
    header, rest = rest.split("-->\n", 1)
    assert header.startswith("<!-- A copy of sdwebui_tpu/server/webui.html")
    assert doctype + "\n" + rest == theirs


#: (JAX module, port module, names whose source text is the same once the
#: package's name is the JAX one)
UI_SHARED = [
    ("sdwebui_tpu.utils.timer", "sdwebui_tpu_torch.utils.timer", ("Timer",)),
    ("sdwebui_tpu.runtime.console", "sdwebui_tpu_torch.runtime.console",
     ("update", "finish", "_BAR_W")),
    ("sdwebui_tpu.utils.config_states", "sdwebui_tpu_torch.utils.config_states",
     ("_webui_info", "save_config_state", "list_config_states", "CONFIG_STATES_DIR")),
    ("sdwebui_tpu.extensions", "sdwebui_tpu_torch.extensions",
     ("Extension", "_topo_sort", "check_updates", "_normalize_git_url", "_SORT_KEYS",
      "DEFAULT_INDEX_URL")),
    ("sdwebui_tpu.scripts.compat", "sdwebui_tpu_torch.scripts.compat",
     ("_CALLBACK_ALIASES", "shim_installed")),
]


@pytest.mark.parametrize("jax_mod,port_mod,names", UI_SHARED,
                         ids=[m[1].rsplit(".", 1)[1] for m in UI_SHARED])
def test_ui_host_sources_equal_jax(jax_mod, port_mod, names):
    """The start-up timer and the console line are copies; config states,
    extensions and the compat shim share these parts with JAX's."""
    import importlib
    import inspect

    theirs, ours = importlib.import_module(jax_mod), importlib.import_module(port_mod)
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        if callable(a):
            src = inspect.getsource(a).replace("sdwebui_tpu_torch.", "sdwebui_tpu.")
            if name == "shim_installed":    # the port's passes the Engine's state and flags
                src = src.replace("extension_path: str = \"\", state=None, cmd_opts=None",
                                  "extension_path: str = \"\"").replace(
                    "build_shim(extension_path, state, cmd_opts)", "build_shim(extension_path)")
            assert src == inspect.getsource(b), name
        else:
            assert a == b, name
    assert theirs.__name__ != ours.__name__


def test_colour_table_equals_pillows():
    """utils/image_color's COLORMAP is Pillow 12.1.0's ImageColor.colormap,
    name for name (the table both packages' colour options go through)."""
    from PIL import ImageColor

    from sdwebui_tpu_torch.utils import image_color

    assert set(image_color.COLORMAP) == set(ImageColor.colormap)
    for name in image_color.COLORMAP:
        assert image_color.getrgb(name) == ImageColor.getrgb(name), name
