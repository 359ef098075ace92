"""The port's web UI page and the routes it fetches, against the JAX
package: the page's static checks of ``tests/test_webui_shell.py`` run on
the port's copy and route table, every route the page fetches answering on
the tiny CPU server, each new internal route's answer equal to JAX's
handler's on the same inputs (token counts, parsed infotexts, options
metadata, ui-config, localization, styles, previews and user metadata,
last-result, sysinfo's keys), image URLs (refused for non-global hosts
before any connection; fetched from a local server through a stub
resolver), the console line, profiling and the server commands."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import http.server
import inspect
import io
import json
import re
import sys
import threading
import types
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import test_webui_shell as shell
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.text import styles as jax_styles
from sdwebui_tpu.text import tokenizer as jax_tok
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.networks.extra_networks import DEFAULT_LORA_DIRS, set_lora_dirs
from sdwebui_tpu_torch.server import api as port_api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.text import tokenizer as port_tok
from sdwebui_tpu_torch.utils import url_fetch
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import decode_png, encode_png

PAGE = Path(__file__).resolve().parents[1] / "sdwebui_tpu_torch/server/webui.html"
STYLES = ("name,prompt,negative_prompt\n"
          "painterly,\"{prompt}, oil painting\",photo\n"
          "plain,high detail,\n"
          "neg,,\"lowres, {prompt}\"\n")


@pytest.fixture(scope="module")
def html():
    return PAGE.read_text()


@pytest.fixture(scope="module")
def script(html):
    return re.search(r"<script>(.*)</script>", html, re.S).group(1)


@pytest.fixture(scope="module")
def payload_fields(script):
    m = re.search(r"const PAYLOAD_FIELDS = JSON\.parse\(`(\{.*?\})`\)", script, re.S)
    return json.loads(m.group(1))


@pytest.fixture
def ui(tmp_path, monkeypatch):
    """A tiny CPU Engine's Api in a fresh working directory (ui-config.json,
    localizations/, extensions/ and the default model directories land
    there) and JAX's Api over the same styles file."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "styles.csv").write_text(STYLES, encoding="utf-8")
    engine = Engine(device="cpu", tiny=True, styles_path=str(tmp_path / "styles.csv"),
                    embeddings_dir=str(tmp_path / "embeddings"), outdir=str(tmp_path / "out"))
    (tmp_path / "jax-styles.csv").write_text(STYLES, encoding="utf-8")
    jax = jax_api.Api.__new__(jax_api.Api)
    jax.engine = types.SimpleNamespace(
        styles=jax_styles.StyleDatabase(str(tmp_path / "jax-styles.csv")),
        sd_model=types.SimpleNamespace(
            conditioner=types.SimpleNamespace(tokenizer=jax_tok.FallbackTokenizer()),
            title="tiny", sha256="", kind="sd1"))
    jax._last_result = None
    yield port_api.Api(engine), jax, tmp_path


# ---- the page: JAX's static checks on the port's copy ------------------------

#: tests/test_webui_shell.py's checks of the page itself (the route-table
#: and schema checks are restated against the port below)
PAGE_CHECKS = [name for name, fn in vars(shell).items()
               if name.startswith("test_") and callable(fn)
               and set(inspect.signature(fn).parameters) <= {"html", "script", "payload_fields"}
               and inspect.signature(fn).parameters
               and name not in ("test_every_fetched_route_is_registered",
                                "test_payload_fields_match_schema")]


@pytest.mark.parametrize("name", PAGE_CHECKS)
def test_page_checks_of_jax_hold_on_the_port_page(name, html, script, payload_fields):
    fn = getattr(shell, name)
    args = {"html": html, "script": script, "payload_fields": payload_fields}
    fn(**{k: args[k] for k in inspect.signature(fn).parameters})


def _page_routes(html) -> set:
    found = set()
    for quote in ('"', "'", "`"):
        found |= set(re.findall(quote + r"(/(?:sdapi/v1|internal|controlnet)/[^" + quote
                                + r"?$ ]*)", html))
    return found


def test_route_table_holds_jax_and_the_page(html, script):
    api = port_api.Api(Engine(device="cpu", tiny=True))
    jax_src = Path(jax_api.__file__).read_text()
    jax_routes = set(re.findall(r'r\("(GET|POST)", "([^"]+)"', jax_src))
    assert len(jax_routes) >= 72
    assert jax_routes <= set(api.routes)
    paths = {p for _, p in api.routes}
    fetched = set(re.findall(r'fetch\("([^"$]+?)"', script))
    fetched |= set(re.findall(r"fetch\('([^'$]+?)'", script))
    fetched |= _page_routes(html)
    assert len(fetched) >= 46
    assert not {f for f in fetched if f not in paths}


def test_payload_fields_are_port_request_fields(payload_fields):
    """The page's generate body (PAYLOAD_FIELDS) names only fields the
    port's request tables take (JAX's check holds them to its pydantic
    schema)."""
    txt = {**port_api.FIELDS, **port_api.HIRES_FIELDS, **port_api.NEUTRAL}
    img = {**port_api.FIELDS, **port_api.IMG2IMG_FIELDS, **port_api.NEUTRAL,
           **port_api.HIRES_NEUTRAL, **port_api.IMG2IMG_NEUTRAL}
    for section, fields in payload_fields.items():
        target = shell.SECTION_MODEL[section]
        for name in fields:
            if target in ("txt", "both"):
                assert name in txt, f"{section}.{name}"
            if target in ("img", "both"):
                assert name in img, f"{section}.{name}"


#: bodies that answer fast (a refusal or an empty result) on routes that
#: would otherwise generate or read the network
CHEAP = {"/sdapi/v1/txt2img": {"steps": 0}, "/sdapi/v1/img2img": {"steps": 0},
         "/sdapi/v1/train/embedding": {"data_root": "nope"},
         "/sdapi/v1/train/hypernetwork": {"data_root": "nope"},
         "/sdapi/v1/create/embedding": {"name": "e", "num_vectors_per_token": 1},
         "/sdapi/v1/create/hypernetwork": {"name": "h", "enable_sizes": [8]}}


def test_every_page_route_answers(ui, html):
    """Every route the page fetches answers on the tiny CPU server, with
    each method the table holds; none is the route-absent 404."""
    api, _, tmp = ui
    (tmp / "index.json").write_text(json.dumps(shell_index()))
    cheap = dict(CHEAP, **{"/internal/extensions/available": {"url": str(tmp / "index.json")}})
    answered = 0
    for path in sorted(_page_routes(html)):
        for (method, route) in list(api.routes):
            if route != path:
                continue
            status, out = api.handle(method, path, None if method == "GET"
                                     else dict(cheap.get(path, {})))
            assert not (status == 404 and out == {"detail": "Not Found"}), (method, path)
            assert status != 500, (method, path, out)
            answered += 1
    assert answered >= 46
    assert api.handle("GET", "/no/such/route", None) == (404, {"detail": "Not Found"})


def shell_index():
    return {"tags": {"script": "scripts"}, "extensions": [
        {"name": "alpha-tools", "url": "https://x/alpha-tools.git", "description": "alpha",
         "added": "2023-01-02", "tags": ["script"], "stars": 5}]}


def test_page_and_raw_routes_over_http(ui):
    api, _, tmp = ui
    lora_dir = tmp / "Lora"
    lora_dir.mkdir()
    write_safetensors(str(lora_dir / "card.safetensors"), {"x": torch.zeros(1)})
    png = encode_png(np.full((4, 4, 3), 7, np.uint8))
    (lora_dir / "card.preview.png").write_bytes(png)
    set_lora_dirs([str(lora_dir)])
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), port_api.make_handler(api))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/") as r:
            assert r.headers["Content-Type"] == "text/html; charset=utf-8"
            assert r.read() == PAGE.read_bytes()
        with urllib.request.urlopen(base + "/internal/extra-networks/preview?name=card") as r:
            assert r.headers["Content-Type"] == "image/png" and r.read() == png
        with urllib.request.urlopen(base + "/internal/sysinfo-download") as r:
            assert r.headers["Content-Disposition"].startswith('attachment; filename="sysinfo-')
            assert json.loads(r.read())["backend"] == "cpu"
        with urllib.request.urlopen(base + "/sdapi/v1/loras") as r:
            (card,) = json.loads(r.read())
        assert card["preview"] == "/internal/extra-networks/preview?name=card"
    finally:
        server.shutdown()
        server.server_close()
        set_lora_dirs(DEFAULT_LORA_DIRS)


# ---- the internal routes against JAX's handlers ------------------------------

def _bpe_pair():
    vocab = {}
    for i, piece in enumerate(sorted(set(port_tok.bytes_to_unicode().values()))):
        vocab[piece] = i
        vocab[piece + "</w>"] = 1000 + i
    merges = [("c", "a"), ("ca", "t</w>"), ("d", "o"), ("do", "g</w>")]
    vocab.update({"ca": 3000, "cat</w>": 3001, "do": 3002, "dog</w>": 3003})
    return port_tok.ClipBPETokenizer(vocab, merges), jax_tok.ClipBPETokenizer(vocab, merges)


TOKEN_BODIES = [
    {"text": "a (red:1.2) cat BREAK a dog, [blue] sky"},
    {"text": "x " * 80 + "BREAK tail"},
    {"text": "a cat", "styles": ["painterly", "plain"]},
    {"text": "blurry", "styles": ["neg"], "negative": True},
    {"text": ""},
    {"text": "BREAK BREAK a"},
]


@pytest.mark.parametrize("bpe", [False, True])
@pytest.mark.parametrize("with_styles", [True, False])
def test_token_count_equals_jax(ui, bpe, with_styles):
    api, jax, _ = ui
    if bpe:
        ours, theirs = _bpe_pair()
        api.engine.sd_model.conditioner.tokenizer = ours
        jax.engine.sd_model.conditioner.tokenizer = theirs
    setting = {"include_styles_into_token_counters": with_styles}
    with opts.override(setting), jax_opts.override(setting):
        for body in TOKEN_BODIES:
            status, out = api.handle("POST", "/internal/token-count", dict(body))
            assert status == 200 and out == jax.token_count(dict(body)), body


def test_chip_smoke_token_count_is_jax():
    """chip_smoke 4p (c) holds the card server's token-count of its BREAK
    prompt to UI_BREAK_TOKENS: JAX's answer over the fallback tokenizer,
    and the port's on the CPU."""
    import chip_smoke

    assert isinstance(port_tok.get_tokenizer(), port_tok.FallbackTokenizer)
    jax = jax_api.Api.__new__(jax_api.Api)
    jax.engine = types.SimpleNamespace(sd_model=types.SimpleNamespace(
        conditioner=types.SimpleNamespace(tokenizer=jax_tok.FallbackTokenizer())))
    body = {"text": chip_smoke.UI_BREAK_PROMPT}
    assert jax.token_count(dict(body)) == chip_smoke.UI_BREAK_TOKENS
    api = port_api.Api(Engine(device="cpu", tiny=True))
    assert api.handle("POST", "/internal/token-count", body) == (200, chip_smoke.UI_BREAK_TOKENS)


INFOTEXTS = [
    "a cat, oil painting\nNegative prompt: photo\nSteps: 20, Sampler: Euler a, CFG scale: 7.5, "
    "Seed: 1234, Size: 512x768, Model hash: abc, Model: m, Clip skip: 2",
    "a dog, high detail\nSteps: 4, Sampler: DPM++ 2M, Schedule type: Karras, Seed: 9, "
    "Size: 64x64, Hires upscale: 2, Hires upscaler: Latent, Denoising strength: 0.7",
    "just a prompt",
    "",
]


@pytest.mark.parametrize("setting", [
    {}, {"infotext_styles": "Ignore"}, {"infotext_styles": "Apply"},
    {"infotext_skip_pasting": ["Seed", "Size-1"]}, {"disable_weights_auto_swap": False}])
def test_parse_infotext_equals_jax(ui, setting):
    api, jax, _ = ui
    with opts.override(setting), jax_opts.override(setting):
        for text in INFOTEXTS:
            status, out = api.handle("POST", "/internal/parse-infotext", {"text": text})
            assert status == 200 and out == jax.parse_infotext({"text": text}), text


def test_options_metadata_ui_config_and_localization_equal_jax(ui):
    api, jax, tmp = ui
    assert api.handle("GET", "/internal/options-metadata", None) == (
        200, jax.options_metadata())
    assert api.handle("GET", "/internal/ui-config", None) == (200, jax.ui_config_get()) == \
        (200, {})
    config = {"txt2img/Steps/value": 30, "img2img/Prompt/visible": True}
    assert api.handle("POST", "/internal/ui-config", config) == (200, jax.ui_config_set(config))
    assert api.handle("GET", "/internal/ui-config", None) == (200, config)
    (tmp / "localizations").mkdir()
    (tmp / "localizations" / "xx.json").write_text(json.dumps({"Generate": "Gen"}))
    for name in ("None", "xx", "missing"):
        with opts.override({"localization": name}), jax_opts.override({"localization": name}):
            assert api.handle("GET", "/internal/localization", None) == (
                200, jax.localization())


def test_save_and_delete_style_equal_jax(ui):
    api, jax, tmp = ui
    for body in ({"name": "new", "prompt": "{prompt}, art", "negative_prompt": "bad"},
                 {"name": "plain", "prompt": "replaced"}):
        assert api.handle("POST", "/internal/save-style", dict(body)) == (
            200, jax.save_style(dict(body)))
    assert api.handle("POST", "/internal/delete-style", {"name": "neg"}) == (
        200, jax.delete_style({"name": "neg"}))
    assert (tmp / "styles.csv").read_bytes() == (tmp / "jax-styles.csv").read_bytes()
    assert api.handle("POST", "/internal/delete-style", {"name": "neg"})[0] == 404
    with pytest.raises(jax_api.ApiError):
        jax.delete_style({"name": "neg"})
    assert api.handle("POST", "/internal/save-style", {"name": " "})[0] == 400


def test_network_previews_and_user_metadata_equal_jax(ui, monkeypatch):
    api, jax, tmp = ui
    from sdwebui_tpu.networks import extra_networks as jax_networks

    lora_dir = tmp / "Lora"
    lora_dir.mkdir()
    write_safetensors(str(lora_dir / "card.safetensors"), {"x": torch.zeros(1)})
    set_lora_dirs([str(lora_dir)])
    monkeypatch.setattr(jax_networks, "default_registry", lambda: types.SimpleNamespace(
        files={"card": str(lora_dir / "card.safetensors")}))
    try:
        for call in (lambda: api.handle("GET", "/internal/extra-networks/preview",
                                        {"name": "card"})[0],):
            assert call() == 404
        with pytest.raises(jax_api.ApiError):
            jax.extra_network_preview({"name": "card"})
        rng = np.random.default_rng(3)
        pixels = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
        png = base64.b64encode(encode_png(pixels, {"parameters": "own text"})).decode()
        target = str(lora_dir / "card.preview.png")
        results = []
        for body in ({"name": "card", "image": png},
                     {"name": "card", "image": "data:image/png;base64," + png,
                      "geninfo": "given"}):
            assert api.handle("POST", "/internal/extra-networks/preview", dict(body)) == (
                200, {"path": target})
            ours = decode_png(open(target, "rb").read())
            assert jax.extra_network_set_preview(dict(body)) == {"path": target}
            theirs = decode_png(open(target, "rb").read())
            np.testing.assert_array_equal(ours[0], theirs[0])
            assert ours[1]["parameters"] == theirs[1]["parameters"]
            results.append(ours[1]["parameters"])
        assert results == ["own text", "given"]
        status, raw = api.handle("GET", "/internal/extra-networks/preview", {"name": "card"})
        want = jax.extra_network_preview({"name": "card"})
        assert status == 200 and (raw.body, raw.content_type) == (want.body, want.content_type)
        meta = {"name": "card", "description": "a card", "activation text": "trigger",
                "preferred weight": 0.8}
        assert api.handle("POST", "/internal/extra-networks/user-metadata", dict(meta)) == (
            200, {"path": str(lora_dir / "card.json")})
        ours = (lora_dir / "card.json").read_bytes()
        assert jax.extra_network_user_metadata(dict(meta)) == {"path": str(lora_dir / "card.json")}
        assert ours == (lora_dir / "card.json").read_bytes()
        (card,) = api.handle("GET", "/sdapi/v1/loras", None)[1]
        assert card["user_metadata"] == {k: v for k, v in meta.items() if k != "name"}
        assert api.handle("POST", "/internal/extra-networks/user-metadata",
                          {"name": "nope"})[0] == 404
    finally:
        set_lora_dirs(DEFAULT_LORA_DIRS)


def test_last_result_sysinfo_and_startup_profile(ui):
    api, jax, _ = ui
    assert api.handle("GET", "/internal/last-result", None)[0] == 404
    with pytest.raises(jax_api.ApiError):
        jax.last_result({})
    status, res = api.handle("POST", "/sdapi/v1/txt2img", {"steps": 1, "width": 64,
                                                           "height": 64, "seed": 3})
    assert status == 200
    assert api.handle("GET", "/internal/last-result", None) == (
        200, {"images": res["images"], "info": res["info"]})
    # the keys of JAX's report, with torch's in place of jax's
    ours = api.handle("GET", "/internal/sysinfo", None)[1]
    theirs = jax.sysinfo()
    assert set(ours) == set(theirs) - {"jax"} | {"torch", "device_name"}
    assert (ours["backend"], ours["device_count"], ours["device_name"]) == ("cpu", 1, None)
    assert ours["checkpoint"] == api.engine.sd_model.title
    assert ours["config"] == opts.data
    status, prof = api.handle("GET", "/internal/profile-startup", None)
    assert status == 200 and set(prof) == {"total", "records"}
    assert "create engine/list SD models" in prof["records"]


# ---- image URLs ----------------------------------------------------------------

@pytest.fixture
def no_network(monkeypatch):
    """url_fetch's socket opener replaced by a recorder that never connects."""
    opened = []

    def refuse(address, port, timeout):
        opened.append((address, port))
        raise AssertionError("a connection was attempted")
    monkeypatch.setattr(url_fetch, "open_socket", refuse)
    return opened


@pytest.mark.parametrize("address", ["127.0.0.1", "10.1.2.3", "192.168.0.9", "172.16.5.5",
                                     "169.254.169.254", "::1", "fe80::1", "fc00::5",
                                     "::ffff:127.0.0.1", "0.0.0.0", "100.64.0.1"])
def test_image_urls_to_local_addresses_refused(ui, monkeypatch, no_network, address):
    api, _, _ = ui
    monkeypatch.setattr(url_fetch, "resolve", lambda host, port: ["93.184.216.34", address])
    status, out = api.handle("POST", "/sdapi/v1/png-info",
                             {"image": "http://images.example/cat.png"})
    assert status == 400 and "local resource not allowed" in out["detail"]
    assert no_network == []


def test_image_urls_refused_by_option_and_for_real_local_names(ui, no_network):
    api, _, _ = ui
    for url in ("http://127.0.0.1:9/x.png", "http://localhost/x.png", "https://[::1]/x.png"):
        status, out = api.handle("POST", "/sdapi/v1/png-info", {"image": url})
        assert status == 400 and "local resource" in out["detail"], url
    with opts.override({"api_enable_requests": False}):
        status, out = api.handle("POST", "/sdapi/v1/png-info",
                                 {"image": "http://images.example/x.png"})
    assert status == 400 and "api_enable_requests" in out["detail"]
    status, out = api.handle("POST", "/sdapi/v1/png-info", {"image": "ftp://a/x.png"})
    assert status == 400
    assert no_network == []


def test_image_url_fetched_through_a_stub_resolver(ui, monkeypatch):
    """A URL whose host "resolves" (stub) to a global address is fetched
    from that address (the stub socket opener connects it to a local
    server), with opts.api_useragent, and decoded as a base64 field is."""
    api, _, _ = ui
    pixels = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    png = encode_png(pixels, {"parameters": "from a URL"})
    seen = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.update(path=self.path, ua=self.headers.get("User-Agent"),
                        host=self.headers.get("Host"))
            code = 200 if self.path.startswith("/cat.png") else 404
            self.send_response(code)
            self.send_header("Content-Length", str(len(png) if code == 200 else 0))
            self.end_headers()
            if code == 200:
                self.wfile.write(png)

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    opened = []
    real_open = url_fetch.open_socket

    def to_local(address, port, timeout):
        opened.append((address, port))
        return real_open("127.0.0.1", server.server_address[1], timeout)
    monkeypatch.setattr(url_fetch, "resolve", lambda host, port: ["93.184.216.34"])
    monkeypatch.setattr(url_fetch, "open_socket", to_local)
    try:
        with opts.override({"api_useragent": "port-test/1.0"}):
            status, out = api.handle("POST", "/sdapi/v1/png-info",
                                     {"image": "http://images.example:8080/cat.png?v=1"})
        assert status == 200 and out["info"] == "from a URL"
        assert opened == [("93.184.216.34", 8080)]
        assert seen == {"path": "/cat.png?v=1", "ua": "port-test/1.0",
                        "host": "images.example:8080"}
        status, out = api.handle("POST", "/sdapi/v1/png-info",
                                 {"image": "http://images.example/missing.png"})
        assert status == 400 and "HTTP 404" in out["detail"]
    finally:
        server.shutdown()
        server.server_close()


# ---- the console line, profiling and the server commands ----------------------

class _Tty(io.StringIO):
    def isatty(self):
        return True


def test_console_line_from_the_step_callback(ui, monkeypatch):
    """JAX's console checks on the port's copy, and the Engine's step
    callback drawing the line only on a TTY."""
    from sdwebui_tpu_torch.runtime import console

    monkeypatch.setattr(sys, "stderr", io.StringIO())
    console.update(5, 20, 0, 4)
    assert sys.stderr.getvalue() == ""
    monkeypatch.setattr(sys, "stderr", _Tty())
    console._last_draw[0] = 0.0
    console.update(5, 20, 0, 4)
    assert "5/20" in sys.stderr.getvalue() and "job 1/4" in sys.stderr.getvalue()
    monkeypatch.setattr(sys, "stderr", _Tty())
    console._last_draw[0] = 0.0
    with opts.override({"multiple_tqdm": False}):
        console.update(5, 20, 0, 4)
    assert "job" not in sys.stderr.getvalue()
    console._line_open[0] = False

    api, _, _ = ui
    monkeypatch.setattr(sys, "stderr", _Tty())
    assert api.handle("POST", "/sdapi/v1/txt2img", {"steps": 3, "width": 64, "height": 64,
                                                    "sampler_name": "Euler"})[0] == 200
    out = sys.stderr.getvalue()
    assert "   3/3 [" in out and out.endswith("\n") and not console._line_open[0]


def test_profiling_counts_the_pad_it_kept(caplog, monkeypatch):
    """A finished trace's kernel launches against its kernel records, by
    correlation id: the first PAD_KERNELS launches are the pad's, counted
    as kept; the generation's launches with no kernel record are counted
    as lost, with a warning."""
    from torch.autograd import DeviceType

    from sdwebui_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "PAD_KERNELS", 3)

    def ev(name, device, corr, t):
        return types.SimpleNamespace(name=lambda: name, device_type=lambda: device,
                                     correlation_id=lambda: corr, start_ns=lambda: t)

    def prof(events):
        return types.SimpleNamespace(profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events)))

    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    launches = [ev("cudaLaunchKernel", DeviceType.CPU, c, 10 * c) for c in range(1, 7)]
    launches[-1] = ev("cuLaunchKernel", DeviceType.CPU, 6, 60)      # a driver launch
    kernels = [ev(spin, DeviceType.CUDA, c, 10 * c + 5) for c in (1, 2, 3)] \
        + [ev("attn_tc_kernel", DeviceType.CUDA, c, 10 * c + 5) for c in (4, 5, 6)]
    with caplog.at_level("WARNING", logger=profiling.__name__):
        assert profiling._count_lost(prof(launches + kernels)) == (3, 0)
        assert caplog.records == []
        # the pad's first two and the generation's first kernel lost
        assert profiling._count_lost(prof(launches[::-1] + kernels[2:3] + kernels[4:])) == (1, 1)
    assert "lost 1 of the generation's 3 kernel records (and 2 of 3 padding" in caplog.text


def test_profiling_writes_a_chrome_trace(ui, monkeypatch):
    api, _, tmp = ui
    import torch.profiler

    real = torch.profiler.profile
    entered = []

    def counted(*a, **k):
        entered.append(k)
        return real(*a, **k)
    monkeypatch.setattr(torch.profiler, "profile", counted)
    body = {"steps": 1, "width": 64, "height": 64}
    assert api.handle("POST", "/sdapi/v1/txt2img", dict(body))[0] == 200
    assert entered == []                       # off: no profiler in the way
    path = tmp / "traces" / "gen.json"
    status, out = api.handle("POST", "/sdapi/v1/txt2img", dict(body, override_settings={
        "profiling_enable": True, "profiling_filename": str(path),
        "profiling_with_stack": False}))
    assert status == 200, out
    (kw,) = entered
    assert [a.name for a in kw["activities"]] == ["CPU"] and kw["with_stack"] is False
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    status, out = api.handle("POST", "/sdapi/v1/options", {"profiling_enable": True,
                                                           "profiling_activities": []})
    try:
        assert api.handle("POST", "/sdapi/v1/img2img", dict(body, init_images=[
            base64.b64encode(encode_png(np.full((64, 64, 3), 90, np.uint8))).decode()]))[0] == 200
        assert len(entered) == 1                # a CPU generation with the host off: nothing
    finally:
        opts.set("profiling_enable", False)
        opts.set("profiling_activities", ["CPU"])


def test_server_commands_end_main(tmp_path, monkeypatch, capsys):
    """/server-restart is logged and waited past; /server-stop and
    /server-kill end main() with 0 and the server with it."""
    from sdwebui_tpu_torch.server import __main__ as server_main

    monkeypatch.chdir(tmp_path)
    real = port_api.make_server
    for command in ("server-stop", "server-kill"):
        made = []

        def capture(*a, **k):
            made.append(real(*a, **k))
            return made[-1]
        monkeypatch.setattr(server_main, "make_server", capture)
        result = {}
        thread = threading.Thread(target=lambda: result.setdefault("rc", server_main.main(
            ["--model", "sd15", "--tiny", "--device", "cpu", "--port", "0"])))
        thread.start()
        for _ in range(600):
            if made and "serving" in capsys.readouterr().out:
                break
            threading.Event().wait(0.1)
        url = f"http://127.0.0.1:{made[0].server_address[1]}/sdapi/v1/"
        for route in ("server-restart", command):
            urllib.request.urlopen(urllib.request.Request(url + route, data=b"{}",
                                                          method="POST")).read()
        thread.join(30)
        assert not thread.is_alive() and result == {"rc": 0}
        with pytest.raises(OSError):
            urllib.request.urlopen(url + "samplers", timeout=5)
