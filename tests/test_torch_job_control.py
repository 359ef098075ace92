"""Job control in the port (CPU, tiny models): progress, interrupt, skip and
live previews on the server, held to the JAX package's state machine and
route handlers.

A skip ends only the batch in flight and ``job_no`` follows the batches
(both fail on the tree before this port: the flag stayed set and job_no
never moved); an interrupt ends the job, the UI's interrupt with
interrupt_after_current finishes the image in flight first.  The live
preview of every show_progress_type is JAX's image (the approximations
equal, the full VAE within 1 level).  The routes answer with the JAX
handlers' keys and types, and are read from one snapshot of the state
while another thread holds the queue lock.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import base64
import io
import json
import os
import sys
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.models import vae_approx as jax_va
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.runtime.state import state as jax_state
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.postprocessing import faces as port_faces
from sdwebui_tpu_torch.postprocessing import upscalers
from sdwebui_tpu_torch.runtime.state import State
from sdwebui_tpu_torch.server.api import Api, make_server
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.utils import webp
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import f32_policies, models  # noqa: F401


@pytest.fixture
def engine():
    return Engine(device="cpu", tiny=True, seed=3)


def _spy(engine, on_step=None):
    """Record (job_no, step) of every sampler step; on_step(job_no, i) runs
    before the Engine's own callback sees the step."""
    seen = []
    real = engine._step_callback

    def spy(i, n, latents):
        seen.append((engine.state.job_no, i))
        if on_step is not None:
            on_step(engine.state.job_no, i)
        return real(i, n, latents)

    engine._step_callback = spy
    return seen


def _params(**kw):
    base = dict(prompt="a cat", seed=40, steps=4, width=64, height=64, n_iter=2,
                override_settings={"live_previews_enable": False})
    base.update(kw)
    return GenerationParams(**base)


# --------------------------------------------------------------------------
# the Engine's callbacks
# --------------------------------------------------------------------------

def test_skip_ends_only_the_batch_in_flight(engine):
    """JAX's step callback clears the flag (app.py:446-448): batch 0 stops
    at its second step, batch 1 runs all four and gives the image an
    un-skipped job gives for it."""
    seen = _spy(engine, lambda job, i: engine.state.skip() if (job, i) == (0, 1) else None)
    res = engine.txt2img(_params())
    assert seen == [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2), (1, 3)]
    full = Engine(device="cpu", tiny=True, seed=3).txt2img(_params())
    images, ref = res.images[res.index_of_first_image:], full.images[full.index_of_first_image:]
    assert len(images) == 2
    np.testing.assert_array_equal(images[1], ref[1])
    assert not np.array_equal(images[0], ref[0])
    assert not engine.state.skipped


def test_job_no_and_progress_follow_the_batches(engine):
    """The batch callback advances job_no (app.py:468): the progress over
    n_iter 3 rises from 0 to 1 and never falls."""
    progress = []
    seen = _spy(engine, lambda job, i: progress.append(engine.state.progress))
    engine.txt2img(_params(n_iter=3, steps=3))
    assert [job for job, _ in seen] == [0] * 3 + [1] * 3 + [2] * 3
    assert progress == sorted(progress) and progress[0] == 0.0
    assert progress[-1] == pytest.approx(2 / 3 + 2 / 9)


def test_interrupt_ends_the_job(engine):
    seen = _spy(engine, lambda job, i: engine.state.interrupt() if (job, i) == (0, 1) else None)
    res = engine.txt2img(_params(batch_size=2))
    assert seen == [(0, 0), (0, 1)]
    assert len(res.images) == 2 + 1       # batch 0's two images and their grid


def test_ui_interrupt_finishes_the_image_in_flight(engine):
    """interrupt_after_current (ui_toprow.py:106): the first click lets
    batch 0 finish and stops before batch 1; a second stops at once."""
    seen = _spy(engine, lambda job, i: engine.state.interrupt_ui() if (job, i) == (0, 1)
                else None)
    res = engine.txt2img(_params())
    assert seen == [(0, i) for i in range(4)] and len(res.images) == 1
    clicks = _spy(engine, lambda job, i: engine.state.interrupt_ui() if i in (0, 1) else None)
    engine.txt2img(_params())
    assert clicks == [(0, 0), (0, 1)]
    with opts.override({"interrupt_after_current": False}):
        st = State()
        st.job_count = 2
        st.interrupt_ui()
        assert st.interrupted and not st.stopping_generation


def test_state_matches_jax_interrupt_ui():
    """The same sequence of clicks leaves both state machines alike."""
    port = State()
    jax_state.begin("test")
    try:
        for count in (1, 3):
            port.begin("test", count)
            jax_state.job_count = count
            jax_state.interrupted = jax_state.stopping_generation = False
            for _ in range(2):
                port.interrupt_ui()
                jax_state.interrupt_ui()
                assert (port.interrupted, port.stopping_generation) == \
                    (jax_state.interrupted, jax_state.stopping_generation)
    finally:
        jax_state.end()
        jax_state.interrupted = jax_state.stopping_generation = False


# --------------------------------------------------------------------------
# live previews
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ptype,grid", [("Approx cheap", True), ("Approx NN", True),
                                        ("TAESD", False), ("Full", True)])
def test_preview_matches_jax(models, f32_policies, ptype, grid):  # noqa: F811
    """The preview of sampler-space latents per show_progress_type, a grid
    of the batch with show_progress_grid (app.py:425-459): Approx NN and
    TAESD without their files fall back to the cheap matrix in both."""
    jm, pm = models
    latents = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32)
    engine = Engine(model=pm, device="cpu")
    settings = {"show_progress_type": ptype, "show_progress_grid": grid}
    with opts.override(settings), torch.inference_mode():
        out = engine._preview(torch.from_numpy(latents.transpose(0, 3, 1, 2).copy()))
    if ptype == "Full":
        rgb = jax_proc.decode_first_stage(jm, jnp.asarray(latents))
    else:
        rgb = jax_va.approx_decode(jm.kind, ptype, jnp.asarray(latents))
    pils = jax_images.tensor_to_pil(np.asarray(rgb))
    ref = np.asarray(jax_images.image_grid(pils) if grid else pils[0])
    assert out.shape == ref.shape
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= (1 if ptype == "Full" else 0)


def test_live_previews_during_a_job(engine):
    """Every 2 steps a preview; each batch's last image after it; none with
    live_previews_enable off."""
    ids = []
    _spy(engine, lambda job, i: ids.append(engine.state.id_live_preview))
    engine.txt2img(_params(batch_size=2, steps=4, override_settings={
        "show_progress_every_n_steps": 2, "show_progress_type": "Approx cheap"}))
    assert ids == [0, 0, 1, 1, 3, 3, 4, 4]       # +1 at steps 2, 4; +1 per batch
    assert engine.state.current_image.shape == (64, 64, 3)
    engine.txt2img(_params(n_iter=1))
    assert engine.state.id_live_preview == 1


# --------------------------------------------------------------------------
# the routes
# --------------------------------------------------------------------------

def _set_both(img: np.ndarray):
    """The same mid-job state in the port's Engine and JAX's global state."""
    fields = dict(job="txt2img", job_count=3, job_no=1, sampling_step=5, sampling_steps=10,
                  job_timestamp="20260101000000", skipped=False, interrupted=False,
                  stopping_generation=False, textinfo=None, time_start=time.time() - 2.0)
    for k, v in fields.items():
        setattr(jax_state, k, v)
    jax_state.set_current_image(Image.fromarray(img))
    port = Engine(device="cpu", tiny=True)
    for k, v in fields.items():
        setattr(port.state, k, v)
    port.state.set_current_image(img)
    return Api(port)


def _reset_jax_state():
    jax_state.end()
    jax_state.current_image = None
    jax_state.time_start = 0.0


def _keys_and_types(d: dict) -> dict:
    return {k: (type(v).__name__ if not isinstance(v, dict) else _keys_and_types(v))
            for k, v in d.items()}


def test_progress_routes_match_jax():
    img = np.random.default_rng(6).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    api = _set_both(img)
    try:
        ref = jax_api.Api.progress(None)
        out = api.handle("GET", "/sdapi/v1/progress", None)[1]
        assert _keys_and_types(out) == _keys_and_types(ref)
        assert out["state"] == ref["state"] and out["progress"] == ref["progress"]
        assert out["eta_relative"] == pytest.approx(ref["eta_relative"], rel=0.05)
        np.testing.assert_array_equal(decode_png(base64.b64decode(out["current_image"]))[0],
                                      img)
        for method, body in (("GET", None), ("POST", {"id_task": "x", "live_preview": True}),
                             ("POST", {"live_preview": False})):
            ref = jax_api.Api.internal_progress(None, body)
            out = api.handle(method, "/internal/progress", body)[1]
            assert _keys_and_types(out) == _keys_and_types(ref)
            assert {k: v for k, v in out.items() if k != "live_preview"} == \
                {k: v for k, v in ref.items() if k != "live_preview"}
            if out["live_preview"] is not None:
                head, b64 = out["live_preview"].split(",", 1)
                assert head == "data:image/png;base64"
                np.testing.assert_array_equal(decode_png(base64.b64decode(b64))[0], img)
        # jpeg previews: Pillow's bytes at its default quality, as JAX sends
        # them; webp previews: lossy at Pillow's default quality, the port's
        # encoder within the lossy WebP bound of JAX's Pillow file
        with opts.override({"live_previews_image_format": "jpeg"}), \
                jax_opts.override({"live_previews_image_format": "jpeg"}):
            ref = jax_api.Api.internal_progress(None, None)
            status, res = api.handle("GET", "/internal/progress", None)
        assert status == 200 and res["live_preview"] == ref["live_preview"]
        assert res["live_preview"].startswith("data:image/jpeg;base64,")
        with opts.override({"live_previews_image_format": "webp"}), \
                jax_opts.override({"live_previews_image_format": "webp"}):
            ref = jax_api.Api.internal_progress(None, None)
            status, res = api.handle("GET", "/internal/progress", None)
        assert status == 200 and res["live_preview"].startswith("data:image/webp;base64,")
        ours = base64.b64decode(res["live_preview"].split(",", 1)[1])
        theirs = base64.b64decode(ref["live_preview"].split(",", 1)[1])
        got = webp.decode_webp(ours)[0]
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(ours))))
        err = np.abs(got.astype(int) - img).mean()
        assert err <= 1.25 * np.abs(np.asarray(Image.open(io.BytesIO(theirs)), int) - img).mean()
    finally:
        _reset_jax_state()


def test_idle_progress_matches_jax(engine):
    _reset_jax_state()
    ref = jax_api.Api.progress(None)
    out = Api(engine).handle("GET", "/sdapi/v1/progress", None)[1]
    assert {k: v for k, v in out.items() if k != "state"} == \
        {k: v for k, v in ref.items() if k != "state"}
    assert set(out["state"]) == set(ref["state"])


@pytest.mark.parametrize("route,flag", [("/sdapi/v1/interrupt", "interrupted"),
                                        ("/sdapi/v1/skip", "skipped"),
                                        ("/internal/interrupt", "stopping_generation")])
def test_control_routes_set_the_flags(engine, route, flag):
    engine.state.begin("txt2img", 2)
    assert Api(engine).handle("POST", route, {}) == (200, {})
    snap = engine.state.snapshot()
    assert [k for k in ("interrupted", "skipped", "stopping_generation") if snap[k]] == [flag]


def test_png_info_matches_jax(engine):
    text = "a cat\nNegative prompt: dog\nSteps: 3, Sampler: Euler a, Seed: 9, Size: 64x48"
    png = base64.b64encode(encode_png(np.zeros((48, 64, 3), np.uint8),
                                      {"parameters": text, "other": "x"})).decode()
    ref = jax_api.Api.png_info(None, {"image": png})
    out = Api(engine).handle("POST", "/sdapi/v1/png-info", {"image": png})
    assert out == (200, ref)
    assert Api(engine).handle("POST", "/sdapi/v1/png-info", {})[0] == 404


def test_memory_cmd_flags_and_listings(engine, tmp_path):
    from sdwebui_tpu_torch.models.esrgan import SRVGGNetCompact, register_esrgan_dir

    net = SRVGGNetCompact(nf=8, num_conv=2)
    write_safetensors(str(tmp_path / "realesr-x.safetensors"), net.state_dict())
    names = register_esrgan_dir((str(tmp_path),), device="cpu")
    try:
        api = Api(engine, flags={"port": 7861, "ckpt": None}, realesrgan=names)
        status, mem = api.handle("GET", "/sdapi/v1/memory", None)
        ref = jax_api.schema.MemoryResponse(ram={"free": -1, "used": 1, "total": -1},
                                            cuda={}).model_dump()
        assert status == 200 and set(mem) == set(ref) and mem["ram"]["used"] > 0
        assert mem["cuda"]["system"] == {"error": "unavailable"}
        assert set(mem["cuda"]["events"]) == {"peak_used", "polls"}
        assert api.handle("GET", "/sdapi/v1/cmd-flags", None)[1] == \
            {"port": 7861, "api": True, "ckpt": None}
        assert api.handle("POST", "/sdapi/v1/refresh-vae", {}) == (200, {})
        assert api.handle("GET", "/sdapi/v1/realesrgan-models", None)[1] == [
            {"name": "realesr-x", "path": str(tmp_path / "realesr-x.safetensors"), "scale": 4}]
        assert api.handle("GET", "/sdapi/v1/face-restorers", None)[1][0]["name"] == "None"
    finally:
        for name in names:
            upscalers.unregister_upscaler(name)


def test_progress_is_read_while_the_queue_lock_is_held(engine):
    """A generation in another thread holds the queue lock; /progress
    answers from the state's snapshot all the same."""
    api = Api(engine)
    in_step, release = threading.Event(), threading.Event()
    _spy(engine, lambda job, i: (in_step.set(), release.wait(30)) if (job, i) == (1, 2)
         else None)
    worker = threading.Thread(target=engine.txt2img, args=(_params(),))
    worker.start()
    try:
        assert in_step.wait(60)
        assert not engine.queue_lock.acquire(blocking=False)
        t0 = time.perf_counter()
        status, res = api.handle("GET", "/sdapi/v1/progress", None)
        assert time.perf_counter() - t0 < 5.0
        # the spy holds step index 2 before the Engine has counted it
        assert status == 200 and res["state"]["job_no"] == 1 and \
            res["state"]["sampling_step"] == 2
        assert res["progress"] == pytest.approx(0.5 + 0.5 * 2 / 4)
    finally:
        release.set()
        worker.join(timeout=60)
    assert not worker.is_alive()


def test_snapshot_is_consistent_under_threads():
    """Writers move (step, steps) and job_no together; readers on many
    threads never see a step past its steps or a progress outside [0, 1]."""
    st = State()
    st.begin("txt2img", 4)
    stop = threading.Event()
    bad = []

    def write():
        k = 0
        while not stop.is_set():
            k += 1
            st.set_sampling_step(k % 7 + 1, k % 7 + 1)
            st.set_job_no(k % 4)
            st.set_current_image(np.zeros((2, 2, 3), np.uint8))

    def read():
        while not stop.is_set():
            s = st.snapshot()
            if s["sampling_step"] > s["sampling_steps"] or not 0.0 <= s["progress"] <= 1.0:
                bad.append(s)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=write) for _ in range(2)] + \
        [threading.Thread(target=read) for _ in range((os.cpu_count() or 2) + 2)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not bad, bad[:3]


def test_http_progress_during_a_generation(engine):
    """Over HTTP: polls during a threaded txt2img see the progress rise and
    a live preview arrive; a /skip in iteration 0 still returns iteration
    1's images."""
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url + path, data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    result = {}
    skipped = threading.Event()
    _spy(engine, lambda job, i: (call("/sdapi/v1/skip", {}), skipped.set())
         if (job, i) == (0, 3) else None)
    body = {"prompt": "a cat", "seed": 5, "steps": 8, "width": 64, "height": 64, "n_iter": 2,
            "override_settings": {"show_progress_every_n_steps": 2,
                                  "show_progress_type": "Approx cheap"}}
    worker = threading.Thread(target=lambda: result.update(call("/sdapi/v1/txt2img", body)))
    worker.start()
    try:
        seen, previews = [], set()
        while worker.is_alive():
            p = call("/sdapi/v1/progress")
            if p["state"]["job"]:
                seen.append(p["progress"])
                if p["current_image"]:
                    previews.add(decode_png(base64.b64decode(p["current_image"]))[0].shape)
            time.sleep(0.005)
        worker.join(timeout=120)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert skipped.is_set() and len(result["images"]) == 2
    assert seen == sorted(seen) and seen
    # the cheap approximation's previews are latent-sized; a batch's image is not
    assert previews and previews <= {(8, 8, 3), (64, 64, 3)}


def test_server_main_wires_the_face_directories(tmp_path, monkeypatch):
    """--gfpgan-models-path and --codeformer-models-path reach faces'
    registry (JAX parses both and never reads them)."""
    from sdwebui_tpu_torch.server import __main__ as server_main

    class FakeServer:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    made = {}
    monkeypatch.setattr(server_main, "make_server",
                        lambda engine, host, port, **kw: made.update(kw) or FakeServer())
    g, c = tmp_path / "g", tmp_path / "c"
    try:
        server_main.main(["--model", "sd15", "--tiny", "--device", "cpu",
                          "--gfpgan-models-path", str(g), "--codeformer-models-path", str(c),
                          "--esrgan-models-path", str(tmp_path / "e"),
                          "--realesrgan-models-path", str(tmp_path / "r")])
        assert port_faces._dirs == {"GFPGAN": [str(g)], "CodeFormer": [str(c)]}
        assert made["flags"]["gfpgan_models_path"] == str(g) and made["realesrgan"] == []
    finally:
        for name, dirs in port_faces.DEFAULT_DIRS.items():
            port_faces.set_model_dirs(name, dirs)
