"""Hypernetwork training and the training routes in the port against the
JAX package (CPU, f32; the models and bounds of ``test_torch_training``).

Bounds: a new hypernetwork equal to JAX's exactly; three HN steps with
dropout off: the losses within 1e-5 relative and the UNet's prediction
with the trained network within 1e-5 (the parameters' note is on its
test); dropout keeps 1 − p of the units (within 0.01) and runs in
training only; the create and train routes answer as JAX's handlers
called unbound, and a run is a job (progress, interrupt).
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import os
import types

import numpy as np
import pytest
import torch

from sdwebui_tpu.networks import hypernetwork as jax_hn
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.training import hypernetwork as jax_hn_train
from sdwebui_tpu_torch.networks import hypernetwork as port_hn
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.training import hypernetwork as port_hn_train
from test_torch_img2img import models  # noqa: F401
from test_torch_training import (_eager_steps, _rel, both_opts, data_dir,  # noqa: F401
                                 train_models)


# --------------------------------------------------------------------------
# hypernetworks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("init", ["Normal", "KaimingUniform", "XavierNormal"])
def test_create_hypernetwork_equals_jax(init):
    kw = dict(dims=(32, 48), layer_structure=(1, 2, 1.5, 1), seed=5, weight_init=init,
              add_layer_norm=True)
    ref = jax_hn.create_hypernetwork(**kw)
    out = port_hn.create_hypernetwork(**kw)
    assert sorted(out.layers) == sorted(int(d) for d in ref)
    for d, (k_ref, v_ref) in ref.items():
        for mod, mod_ref in zip(out.layers[int(d)], (k_ref, v_ref)):
            for layer, layer_ref in zip(mod, mod_ref):
                assert sorted(layer) == sorted(layer_ref)
                for kind, arr in layer_ref.items():
                    np.testing.assert_array_equal(layer[kind].numpy(), arr)
    for args in (((1, 2, 1), False, True), ((1, 2, 2, 1), True, True), ((1, 2, 2, 1), True, False),
                 ((1, 1.5, 3, 2, 1), True, False)):
        assert port_hn.parse_dropout_structure(*args) == jax_hn.parse_dropout_structure(*args)


HN_KW = dict(layer_structure=(1, 2, 1), activation="linear", add_layer_norm=True, steps=3,
             learn_rate="0.001:2, 0.0005:3", batch_size=2, width=64, height=64, seed=1)


def test_hn_training_matches_jax(train_models, data_dir, tmp_path):
    """Three steps, dropout off: the losses, and the UNet's prediction with
    each package's trained network on one input.  The parameters are held
    through what the UNet computes with them: the k MLP's output biases
    have no true gradient (a shift of every key moves each query's scores
    by one constant, which the softmax ignores), and Adam scales the float
    noise there to full steps, differently in each package."""
    jm, pm = train_models
    with _eager_steps(jax_hn_train):
        ref, ref_losses = jax_hn_train.train_hypernetwork_from_dir(
            jm, "hn", str(data_dir), save_path=str(tmp_path / "j.safetensors"), **HN_KW)
    out, losses = port_hn_train.train_hypernetwork_from_dir(
        pm, "hn", str(data_dir), save_path=str(tmp_path / "p.safetensors"), **HN_KW)
    assert _rel(losses, ref_losses) <= 1e-5
    theirs = port_hn.Hypernetwork({int(d): tuple(
        [{k: torch.from_numpy(np.asarray(v)) for k, v in layer.items()} for layer in mod]
        for mod in pair) for d, pair in ref.items()}, "linear")
    assert {d: [[sorted(layer) for layer in mod] for mod in pair]
            for d, pair in theirs.layers.items()} == \
        {d: [[sorted(layer) for layer in mod] for mod in pair] for d, pair in out.layers.items()}
    g = torch.Generator().manual_seed(2)
    x, ctx = torch.randn((2, 4, 8, 8), generator=g), torch.randn((2, 77, 64), generator=g)
    t = torch.tensor([100.0, 800.0])
    with torch.no_grad():
        got, want = (pm.unet(x, t, ctx, hypernet=hn) for hn in (out, theirs))
        base = pm.unet(x, t, ctx)
    assert _rel(got, want) <= 1e-5 and _rel(got, base) > 1e-4
    # each package's file loads in the other's loader
    loaded, act = jax_hn.load_hypernetwork(str(tmp_path / "p.safetensors"))
    assert act == "linear" and sorted(loaded) == sorted(ref)
    back = port_hn.load_hypernetwork(str(tmp_path / "j.safetensors"), "cpu")
    assert back.activation == "linear" and sorted(back.layers) == sorted(out.layers)


def test_hn_dropout_rates_and_inference():
    """Inverted dropout at the structure's rates in the training forward,
    none outside it, where the module equals JAX's."""
    hn = port_hn.create_hypernetwork(dims=(64,), layer_structure=(1, 2, 2, 1), seed=0)
    structure = port_hn.parse_dropout_structure((1, 2, 2, 1), True, True)
    assert structure == [0.0, 0.3, 0.3, 0.0]
    x = torch.ones((4, 77, 64))
    gen = torch.Generator().manual_seed(0)
    one = [{"weight": torch.eye(64), "bias": torch.zeros(64)}]
    for p in (0.3, 0.5):
        h = port_hn.apply_module(one + one, x, dropout=((0.0, p, 0.0), gen)) - x
        kept = (h != 0).float().mean().item()
        assert abs(kept - (1 - p)) < 0.01
        torch.testing.assert_close(h[h != 0], torch.full_like(h[h != 0], 1 / (1 - p)))
    train = port_hn.Hypernetwork(hn.layers, dropout=(tuple(structure), gen))
    assert not torch.equal(train.context_pair(x)[0], train.context_pair(x)[0])
    a, _ = hn.context_pair(x)
    b, _ = hn.context_pair(x)
    assert torch.equal(a, b) and hn.dropout is None
    ref = jax_hn.apply_hypernetwork_module(
        [{k: v.numpy() for k, v in layer.items()} for layer in hn.layers[64][0]], x.numpy())
    np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_hn_training_with_dropout_runs(models, data_dir):  # noqa: F811
    """Dropout on through the trainer: finite losses, the network moves,
    its file records the structure."""
    pm = models[1]
    out, losses = port_hn_train.train_hypernetwork_from_dir(
        pm, "hn", str(data_dir), **dict(HN_KW, layer_structure=(1, 2, 2, 1),
                                        use_dropout=True, steps=2))
    assert np.isfinite(losses).all() and len(losses) == 2
    fresh = port_hn.create_hypernetwork(dims=(pm.unet_cfg.context_dim,),
                                        layer_structure=(1, 2, 2, 1), seed=1,
                                        add_layer_norm=True)
    d = pm.unet_cfg.context_dim
    assert not torch.equal(out.layers[d][0][0]["weight"], fresh.layers[d][0][0]["weight"])


# --------------------------------------------------------------------------
# the routes
# --------------------------------------------------------------------------

def _jax_handler(name: str, jm):
    """JAX's route `name`, called unbound on a stand-in holding its engine."""
    import threading

    engine = types.SimpleNamespace(sd_model=jm, queue_lock=threading.RLock(),
                                   _attach_embeddings=lambda m: None)
    fake = types.SimpleNamespace(engine=engine)
    return lambda body: getattr(jax_api.Api, name)(fake, body)


def test_training_routes_match_jax(train_models, data_dir, tmp_path, monkeypatch, both_opts):
    jm, pm = train_models
    monkeypatch.chdir(tmp_path)
    both_opts(save_training_settings_to_txt=False, training_write_csv_every=0)
    port_hn.set_hypernetwork_dirs([os.path.join("models", "hypernetworks")])
    try:
        api = Api(Engine(model=pm, device="cpu", hash_cache=None))
        body = {"name": "fresh", "num_vectors_per_token": 2}
        status, got = api.handle("POST", "/sdapi/v1/create/embedding", body)
        assert (status, got) == (200, _jax_handler("create_embedding", jm)(body))
        body = {"name": "fresh-hn", "enable_sizes": [32], "layer_structure": [1, 2, 1],
                "activation_func": "tanh"}
        status, got = api.handle("POST", "/sdapi/v1/create/hypernetwork", body)
        assert (status, got) == (200, _jax_handler("create_hypernetwork", jm)(body))
        assert port_hn.load_hypernetwork("models/hypernetworks/fresh-hn.safetensors",
                                         "cpu").activation == "tanh"
        # one step: the answer's loss is the first step's, before any update
        body = {"embedding_name": "routed", "data_root": str(data_dir), "steps": 1,
                "learn_rate": "0.01", "training_width": 64, "training_height": 64,
                "num_vectors_per_token": 1}
        ref = _jax_handler("train_embedding", jm)(body)
        status, got = api.handle("POST", "/sdapi/v1/train/embedding", body)
        assert (status, got) == (200, ref)
        assert "routed" in api.handle("GET", "/sdapi/v1/embeddings", None)[1]["loaded"]
        body = {"hypernetwork_name": "routed-hn", "data_root": str(data_dir), "steps": 1,
                "learn_rate": "0.001", "training_width": 64, "training_height": 64}
        ref = _jax_handler("train_hypernetwork", jm)(body)
        status, got = api.handle("POST", "/sdapi/v1/train/hypernetwork", body)
        assert (status, got) == (200, ref)
        assert {"name": "routed-hn", "path": os.path.join("models", "hypernetworks",
                                                          "routed-hn.safetensors")} \
            in api.handle("GET", "/sdapi/v1/hypernetworks", None)[1]
        # what JAX answers with an error, the port answers alike; fields it
        # does not read are 422s
        assert api.handle("POST", "/sdapi/v1/train/embedding", {"data_root": "nope"})[0] == 404
        status, got = api.handle("POST", "/sdapi/v1/train/embedding",
                                 {"data_root": str(data_dir), "gradient_step": 2})
        assert status == 422 and "gradient_step" in got["detail"]
        status, got = api.handle("POST", "/sdapi/v1/train/embedding",
                                 {"embedding_name": "e", "data_root": str(data_dir),
                                  "learn_rate": "abc", "steps": 1, "training_width": 64,
                                  "training_height": 64})
        assert status == 400 and "learning rate" in got["detail"]
        # what the port leaves out answers 422 naming it: a family JAX cannot
        # train, a dataset file in a format the port does not read (AVIF)
        xl = Api(Engine(device="cpu", tiny=True, family="sdxl", hash_cache=None))
        status, got = xl.handle("POST", "/sdapi/v1/train/embedding",
                                {"embedding_name": "e", "data_root": str(data_dir), "steps": 1})
        assert status == 422 and "'sdxl'" in got["detail"]
        (tmp_path / "bmp").mkdir()
        (tmp_path / "bmp" / "a.bmp").write_bytes(b"\x00\x00\x00\x1cftypavif" + bytes(16))
        status, got = api.handle("POST", "/sdapi/v1/preprocess",
                                 {"process_src": str(tmp_path / "bmp"),
                                  "process_dst": str(tmp_path / "out")})
        assert status == 422 and "a.bmp: a AVIF image" in got["detail"]
    finally:
        port_hn.set_hypernetwork_dirs([port_hn.DEFAULT_HYPERNETWORK_DIR])


def test_training_job_progress_and_interrupt(models, data_dir, tmp_path, monkeypatch,  # noqa: F811
                                             both_opts):
    """A run is a job: its steps reach /progress; an interrupt stops it
    after the step in flight."""
    pm = models[1]
    monkeypatch.chdir(tmp_path)
    both_opts(save_training_settings_to_txt=False, training_write_csv_every=0)
    engine = Engine(model=pm, device="cpu", hash_cache=None)
    api = Api(engine)
    seen = []
    real = engine.state.set_sampling_step

    def spy(step, steps):
        real(step, steps)
        seen.append((api.handle("GET", "/sdapi/v1/progress", None)[1]["state"]["job"],
                     step, steps))
        if step == 2:
            api.handle("POST", "/sdapi/v1/interrupt", {})

    engine.state.set_sampling_step = spy
    body = {"embedding_name": "stop", "data_root": str(data_dir), "steps": 5,
            "training_width": 64, "training_height": 64}
    status, got = api.handle("POST", "/sdapi/v1/train/embedding", body)
    assert status == 200 and got["info"].startswith("train embedding complete: 2 steps")
    assert seen == [("train-embedding", 1, 5), ("train-embedding", 2, 5)]
    assert api.handle("GET", "/sdapi/v1/progress", None)[1]["state"]["job"] == ""
