"""Textual-inversion training in the port against the JAX package (CPU,
f32): the tiny twin SD1 model of ``test_torch_img2img`` with
a one-level UNet (``TRAIN_UNET``) for the trainers, whose JAX runs are
eager (below).

Bounds: the learn-rate schedule and the templates and captions equal;
the card encoder equal to Pillow's dots in every pixel and each package's
card read by the other's reader to 1e-6; three TI steps: the losses and
the final embedding within 1e-5 relative, the saved Adam moments within
1e-5 (the second, of squares, 3e-5); ``.optim`` saved by either package
loads in the other, the resumed steps agreeing to 1e-5.  The JAX
trainers' steps run under ``jax.disable_jit`` (``_eager_steps``): JAX's
jitted UNet backward on this CPU differs from its own eager one by up to
3.5% of the largest gradient element (XLA's fused backward), enough to
flip the sign of Adam's first step on small elements; eager JAX and the
port agree to 3e-7 of the largest element.
Eager JAX compiles every op apart, so each JAX run is shared by the tests
that read it (module fixtures).  The dataset's tests are in
``test_torch_preprocess.py``, the hypernetwork's and the routes' in
``test_torch_training_hn.py``.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import contextlib
import dataclasses
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.models.configs import UNetConfig
from sdwebui_tpu.networks.textual_inversion import load_embedding_file as jax_load_embedding
from sdwebui_tpu.training import dataset as jax_ds
from sdwebui_tpu.training import image_embedding as jax_card
from sdwebui_tpu.training import textual_inversion as jax_ti
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict
from sdwebui_tpu_torch.networks import image_embedding as port_card
from sdwebui_tpu_torch.networks.textual_inversion import load_embedding_file
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.training import dataset as port_ds
from sdwebui_tpu_torch.training import step as port_step
from sdwebui_tpu_torch.training import textual_inversion as port_ti
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import encode_png
from test_torch_img2img import models  # noqa: F401

SCHEDULES = [("0.005", 100), ("0.001:100, 0.00001:1000, 1e-5:10000", 20000),
             ("0.001:100, 0.00001:1000", 500), ("0.01:50", 100), ("5e-3:-1", 300),
             ("0.1:10,0.01:20,0.001:30", 100)]


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


@contextlib.contextmanager
def _eager_steps(*modules):
    """The `jax.jit` of each JAX trainer module runs its function eagerly
    (its step; the dataset's encode stays jitted)."""
    def eager(fn=None, **_):
        def call(*args, **kwargs):
            with jax.disable_jit():
                return fn(*args, **kwargs)
        return call

    real = {m: m.jax for m in modules}
    for m in modules:
        m.jax = types.SimpleNamespace(**{**vars(jax), "jit": eager})
    try:
        yield
    finally:
        for m, j in real.items():
            m.jax = j


@pytest.fixture
def both_opts():
    """Set options in both packages for one test."""
    saved = []

    def set_(**kw):
        for o in (opts, jax_opts):
            saved.append((o, {k: o.data.get(k) for k in kw}))
            o.data.update(kw)

    yield set_
    for o, old in reversed(saved):
        o.data.update(old)


@pytest.fixture
def data_dir(tmp_path):
    return _write_data(tmp_path / "data")


def _write_data(d):
    """Three 64² PNGs and one 128x64 with alpha, one with a caption file."""
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in ["1-red fox.png", "2-blue bird.png", "3-green frog.png"]:
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(d / name)
    rgba = rng.integers(0, 255, (64, 128, 4), dtype=np.uint8)
    rgba[:32, :, 3] = 255
    Image.fromarray(rgba, "RGBA").save(d / "4-wide cat.png")
    (d / "3-green frog.txt").write_text("frog, green, pond")
    return d


# --------------------------------------------------------------------------
# schedule, templates, captions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec,max_steps", SCHEDULES)
def test_learn_schedule_matches_jax(spec, max_steps):
    ref, ours = jax_ds.LearnRateScheduler(spec, max_steps), port_ds.LearnRateScheduler(spec,
                                                                                      max_steps)
    for step in range(0, max_steps, max(max_steps // 200, 1)):
        assert ours.rate_at(step) == ref.rate_at(step), step
        assert ours.finished == ref.finished
    with pytest.raises(ValueError):
        port_ds.LearnRateScheduler("abc", 100)


def test_templates_and_captions_match_jax(tmp_path):
    for name in jax_ds._TEMPLATES:
        assert port_ds.load_template(name) == jax_ds.load_template(name)
    (tmp_path / "t.txt").write_text("a [name]\n\n  b [filewords]  \n")
    assert port_ds.load_template(str(tmp_path / "t.txt")) == ["a [name]", "b [filewords]"]
    with pytest.raises(ValueError):
        port_ds.load_template("nope")
    (tmp_path / "12-a_big-dog.png").write_bytes(b"")
    (tmp_path / "7 cat.png").write_bytes(b"")
    (tmp_path / "7 cat.txt").write_text(" tabby, cat \n")
    for f in ("12-a_big-dog.png", "7 cat.png"):
        for regex, join in (("", " "), (r"\w+", "+")):
            path = str(tmp_path / f)
            assert port_ds.filename_caption(path, regex, join) == \
                jax_ds.filename_caption(path, regex, join)
    for drop, shuffle in ((0.0, False), (0.4, False), (0.0, True), (0.3, True)):
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        for line in jax_ds._TEMPLATES["subject_filewords"][:5]:
            assert port_ds.create_text(line, "a, b, c, d", "tok", drop, shuffle, a) == \
                jax_ds.create_text(line, "a, b, c, d", "tok", drop, shuffle, b)


# --------------------------------------------------------------------------
# the embedding card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(512, 100), (37, 23), (5, 3), (64, 1)])
def test_style_block_equals_pillow(shape):
    rng = np.random.default_rng(shape[0])
    block = rng.integers(0, 16, shape + (3,), dtype=np.uint8)
    seq = rng.integers(0, 256, 17).tolist()
    np.testing.assert_array_equal(port_card.style_block(block, seq),
                                  jax_card.style_block(block, seq))


def test_cards_cross_read(tmp_path):
    rng = np.random.default_rng(1)
    vec = rng.standard_normal((3, 48)).astype(np.float32)
    data = {"string_to_token": {"*": 265}, "string_to_param": {"*": vec}, "name": "card",
            "step": 7, "sd_checkpoint": None, "sd_checkpoint_name": None}
    preview = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    ours = port_card.insert_image_data_embed(preview, data)
    theirs = np.asarray(jax_card.insert_image_data_embed(Image.fromarray(preview), data))
    np.testing.assert_array_equal(ours, theirs)
    got = jax_card.extract_image_data_embed(Image.fromarray(ours))
    np.testing.assert_allclose(got["string_to_param"]["*"], vec, atol=1e-6)
    got = port_card.extract_image_data_embed(theirs)
    np.testing.assert_allclose(got["string_to_param"]["*"], vec, atol=1e-6)
    # the trainer's card, through both packages' embedding loaders
    path = tmp_path / "card.png"
    path.write_bytes(encode_png(port_ti.card_image("card", vec, 7)))
    np.testing.assert_allclose(np.asarray(jax_load_embedding(str(path)).vec), vec, atol=1e-6)
    emb = load_embedding_file(str(path))
    assert emb.name == "card" and emb.step == 7
    np.testing.assert_allclose(emb.vec.numpy(), vec, atol=1e-6)
    assert port_card.embedding_from_b64(port_card.embedding_to_b64(data))["name"] == "card"


# --------------------------------------------------------------------------
# textual inversion
# --------------------------------------------------------------------------

#: a one-level UNet: fewer ops for the eager JAX runs
TRAIN_UNET = UNetConfig(model_channels=32, num_res_blocks=1, channel_mult=(1,),
                        attention_resolutions=(1,), transformer_depth=(1,), context_dim=64,
                        num_heads=4)
TI_KW = dict(n_vectors=2, steps=3, learn_rate="0.05:2, 0.01:3", batch_size=2, width=64,
             height=64, use_weight=True, seed=0)
#: the options every trainer run here reads
TRAIN_OPTS = dict(save_optimizer_state=True, training_write_csv_every=2,
                  save_training_settings_to_txt=True)


@pytest.fixture(scope="module")
def train_models(models):  # noqa: F811
    jm = dataclasses.replace(models[0], unet_cfg=TRAIN_UNET, unet_params=jax.device_put(
        jax_unet.init_params(TRAIN_UNET, 3, dtype=jax.numpy.float32)))
    return jm, port_sd.from_jax(jm, device="cpu")


@pytest.fixture(scope="module")
def ti_runs(train_models, tmp_path_factory):
    """Three steps of each package's train_embedding_from_dir on one
    dataset, saving at step 2 and at the end: (dataset dir, root of the
    j/ and p/ outputs, JAX's (embedding, losses), the port's)."""
    jm, pm = train_models
    root = tmp_path_factory.mktemp("ti")
    data = _write_data(root / "data")
    saved = {o: dict(o.data) for o in (opts, jax_opts)}
    for o in (opts, jax_opts):
        o.data.update(TRAIN_OPTS)
    try:
        runs = []
        for who, module, model in (("j", jax_ti, jm), ("p", port_ti, pm)):
            os.makedirs(root / who)
            with _eager_steps(jax_ti):
                runs.append(module.train_embedding_from_dir(
                    model, "tok", str(data), save_path=str(root / who / "tok.safetensors"),
                    save_every=2, **TI_KW))
    finally:
        for o, d in saved.items():
            o.data.clear()
            o.data.update(d)
    return data, root, runs[0], runs[1]


def test_ti_training_matches_jax(ti_runs):
    """The losses and the embedding, the files beside it, the card."""
    _, root, (ref, ref_losses), (out, losses) = ti_runs
    assert _rel(losses, ref_losses) <= 1e-5
    assert _rel(out.vec.numpy(), np.asarray(ref.vec)) <= 1e-5 and out.step == 3
    assert sorted(os.listdir(root / "p")) == sorted(os.listdir(root / "j")) == [
        "tok.png", "tok.safetensors", "tok.safetensors.optim", "tok_loss.csv",
        "tok_settings.txt"]
    assert (root / "p" / "tok_settings.txt").read_text().replace("/p/", "/j/") == \
        (root / "j" / "tok_settings.txt").read_text()
    rows = [[f.read_text().splitlines() for f in (root / who / "tok_loss.csv",)][0]
            for who in "pj"]
    assert rows[0][0] == rows[1][0] == "step,loss,learn_rate" and len(rows[0]) == len(rows[1])
    for a, b in zip(rows[0][1:], rows[1][1:]):
        (sa, la, ra), (sb, lb, rb) = a.split(","), b.split(",")
        assert (sa, ra) == (sb, rb) and _rel(float(la), float(lb)) <= 1e-5
    card = load_embedding_file(str(root / "p" / "tok.png"))
    np.testing.assert_allclose(card.vec.numpy(), out.vec.numpy(), atol=1e-6)
    for name in ("leaf0", "leaf1", "leaf2"):
        a = read_state_dict(str(root / "p" / "tok.safetensors.optim"))[name].numpy()
        b = read_state_dict(str(root / "j" / "tok.safetensors.optim"))[name].numpy()
        bound = 3e-5 if name == "leaf2" else 1e-5       # leaf2 holds squares of gradients
        assert a.dtype == b.dtype and a.shape == b.shape and _rel(a, b) <= bound, name


@pytest.mark.parametrize("resumer", ["jax", "port"])
def test_optim_state_resumes_across_packages(train_models, ti_runs, tmp_path, both_opts,
                                             resumer):
    """One more step resumed by one package from the JAX-saved and from the
    port-saved embedding and .optim: the two agree.  The port restores the
    moments and the count (a fresh start differs); JAX reads its count back
    as a shape mismatch and restarts it, on either file."""
    jm, pm = train_models
    data, root, jax_run, port_run = ti_runs
    both_opts(save_optimizer_state=True, save_training_settings_to_txt=False,
              training_write_csv_every=0)
    for saver in "jp":
        leaf0 = read_state_dict(str(root / saver / "tok.safetensors.optim"))["leaf0"]
        assert leaf0.dtype == torch.int32 and leaf0.tolist() == [3]
    module, model = (jax_ti, jm) if resumer == "jax" else (port_ti, pm)
    runs = []
    for saver, (emb, _) in (("j", jax_run), ("p", port_run)):
        kw = dict(TI_KW, steps=1, learn_rate="0.02", use_weight=False,
                  initial_vec=np.asarray(emb.vec))
        shutil.copy(root / saver / "tok.safetensors.optim", tmp_path / f"{saver}.safetensors.optim")
        with _eager_steps(jax_ti):
            runs.append(module.train_embedding_from_dir(
                model, "tok", str(data), save_path=str(tmp_path / f"{saver}.safetensors"), **kw))
    (a, la), (b, lb) = runs
    assert _rel(la, lb) <= 1e-5 and _rel(np.asarray(a.vec), np.asarray(b.vec)) <= 1e-5
    if resumer == "port":
        assert read_state_dict(str(tmp_path / "p.safetensors.optim"))["leaf0"].tolist() == [4]
        fresh, _ = port_ti.train_embedding_from_dir(pm, "tok", str(data), **kw)
        assert _rel(fresh.vec.numpy(), b.vec.numpy()) > 1e-3


def test_ti_step_gradient_matches_plain_path(models):  # noqa: F811
    """step.loss's gradient is the embedding's, and the splice clamps."""
    pm = models[1]
    step, init = port_ti.make_ti_train_step(pm, n_vectors=2)
    tok = pm.conditioner.tokenizer
    toks, pos = port_ti.prepare_tokens(tok, "a photo of {}", 2)
    assert toks[pos:pos + 2].tolist() == [0, 0] and toks[0] == 49406 and toks[-1] == 49407
    emb = torch.zeros((2, pm.conditioner.cfg.width), requires_grad=True)
    lat = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(0))
    t = torch.tensor([500])
    with port_step.training_ctx():
        loss = step.loss(emb, lat, lat.flip(0), t, torch.as_tensor(toks[None], dtype=torch.long),
                         torch.tensor([76]), torch.ones_like(lat))
    loss.backward()
    assert emb.grad is not None and torch.isfinite(emb.grad).all() and emb.grad.abs().max() > 0


def test_training_refuses_what_it_cannot_train(models, both_opts):  # noqa: F811
    pm = models[1]
    with pytest.raises(NotImplementedError, match="sdxl"):
        port_ti.make_ti_train_step(dataclasses.replace(pm, kind="sdxl"))
    both_opts(training_xattention_optimizations=True)
    with pytest.raises(NotImplementedError, match="training_xattention_optimizations"):
        with port_step.training_ctx():
            pass


# --------------------------------------------------------------------------
# the kernels refuse autograd
# --------------------------------------------------------------------------

def test_refuse_autograd_only_with_grad():
    from sdwebui_tpu_torch.ops import refuse_autograd

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="layer_norm has no backward"):
        refuse_autograd("layer_norm", x, None)
    with torch.no_grad():
        refuse_autograd("layer_norm", x, None)
    refuse_autograd("layer_norm", torch.ones(3), None)
    # on the CPU the wrappers run their plain versions, which differentiate
    from sdwebui_tpu_torch.ops import layer_norm as ln

    ln.layer_norm(x.reshape(1, 3), torch.ones(3), torch.zeros(3)).sum().backward()
    assert x.grad is not None


@pytest.mark.cuda
def test_kernels_raise_on_tensors_that_need_grad():
    """Every wrapper, called on the card with an operand that requires
    grad under grad mode, raises instead of returning a detached result;
    under no_grad it launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sdwebui_tpu_torch.ops import conv, flash_attention as fa, layer_norm as ln

    dev = torch.device("cuda")
    q = torch.randn((2, 1024, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn((2, 1024, 64), device=dev, dtype=torch.bfloat16)
    x = torch.randn((64, 320), device=dev, requires_grad=True)
    w = torch.ones(320, device=dev)
    img = torch.randn((1, 8, 16, 16), device=dev, requires_grad=True)
    cw = torch.randn((8, 8, 3, 3), device=dev)
    calls = {"flash_attention": lambda: fa.flash_attention(q, k, k),
             "flash_attention_packed": lambda: fa.flash_attention_packed(
                 q.reshape(1, 2048, 64), k.reshape(1, 2048, 64), k.reshape(1, 2048, 64),
                 num_heads=1),
             "flash_attention_4d": lambda: fa.flash_attention_4d(
                 q[:, :, None], k[:, :, None], k[:, :, None]),
             "layer_norm": lambda: ln.layer_norm(x, w, w),
             "conv3x3": lambda: conv.conv3x3(img, cw)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
        with torch.no_grad():
            assert call().grad_fn is None
