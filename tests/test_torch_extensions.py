"""The port's extensions manager (``extensions.py``), compat shim
(``scripts/compat.py``) and config states (``utils/config_states.py``):
JAX's ``tests/test_extensions.py`` against the port's modules (discovery
and the disable policy, the config-state round trip, the styles asset,
scripts gated off and then loaded and run through the shim, the
Requires order, a local git install and its directory-name check, the
available index), each JAX function's answer beside the port's where both
run, and the Engine, routes and server start-up around them."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from sdwebui_tpu import extensions as jax_ext
from sdwebui_tpu.utils import config_states as jax_states
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch import extensions as ext_mod
from sdwebui_tpu_torch.scripts import framework
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.utils import config_states
from sdwebui_tpu_torch.utils.options import opts

HAS_GIT = shutil.which("git") is not None


@pytest.fixture()
def ext_tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "extensions" / "my-ext").mkdir(parents=True)
    (tmp_path / "extensions" / "other-ext").mkdir(parents=True)
    (tmp_path / "extensions-builtin" / "shipped").mkdir(parents=True)
    yield tmp_path
    for o in (opts, jax_opts):
        o.set("disabled_extensions", [])
        o.set("disable_all_extensions", "none")


def _both(setting: dict):
    for o in (opts, jax_opts):
        for k, v in setting.items():
            o.set(k, v)


def _rows(exts):
    return [(e.name, e.path, e.enabled, e.is_builtin) for e in exts]


@pytest.mark.parametrize("setting", [
    {}, {"disabled_extensions": ["my-ext"]},
    {"disabled_extensions": ["my-ext"], "disable_all_extensions": "extra"},
    {"disable_all_extensions": "all"}])
def test_discovery_and_disable_policy(ext_tree, setting):
    _both(setting)
    names = {e.name: e for e in ext_mod.list_extensions()}
    assert set(names) == {"my-ext", "other-ext", "shipped"}
    assert names["shipped"].is_builtin
    assert _rows(ext_mod.list_extensions()) == _rows(jax_ext.list_extensions())
    assert _rows(ext_mod.active_extensions()) == _rows(jax_ext.active_extensions())
    if setting.get("disable_all_extensions") == "all":
        assert all(not e.enabled for e in names.values())
    elif setting.get("disable_all_extensions") == "extra":
        assert not names["other-ext"].enabled and names["shipped"].enabled
    elif setting:
        assert not names["my-ext"].enabled and names["other-ext"].enabled


def test_config_state_roundtrip(ext_tree):
    opts.set("disabled_extensions", ["other-ext"])
    path = config_states.save_config_state("snap")
    assert os.path.exists(path)
    states = config_states.list_config_states()
    assert states and states[0]["name"] == "snap"
    assert states[0]["extensions"]["other-ext"]["enabled"] is False
    jax_view = jax_states.list_config_states()
    assert [s["filepath"] for s in jax_view] == [s["filepath"] for s in states]
    opts.set("disabled_extensions", [])
    restored = config_states.restore_extension_config(states[0])
    assert restored == ["other-ext"] == jax_states.restore_extension_config(states[0])
    assert opts.get("disabled_extensions") == ["other-ext"]
    # the state's keys are JAX's
    assert set(states[0]) == set(jax_view[0])
    assert set(states[0]["extensions"]["my-ext"]) == set(jax_view[0]["extensions"]["my-ext"])


def test_config_state_applied_once_at_start(ext_tree, monkeypatch):
    """restore_config_state_file in --config-path is applied when the server
    starts, then cleared there (JAX's __main__.py:84-101)."""
    from sdwebui_tpu_torch.server import __main__ as server_main

    opts.set("disabled_extensions", ["my-ext"])
    state_path = config_states.save_config_state("boot")
    opts.set("disabled_extensions", [])
    (ext_tree / "config.json").write_text(json.dumps({"restore_config_state_file": state_path}))
    monkeypatch.setattr(server_main, "wait_for_command", lambda engine, thread: 0)
    try:
        assert server_main.main(["--model", "sd15", "--tiny", "--device", "cpu",
                                 "--port", "0"]) == 0
        assert opts.get("disabled_extensions") == ["my-ext"]
        assert opts.get("restore_config_state_file") == ""
        saved = json.loads((ext_tree / "config.json").read_text())
        assert saved["restore_config_state_file"] == ""
        assert saved["disabled_extensions"] == ["my-ext"]
    finally:
        opts.set("restore_config_state_file", "")


def test_extension_styles_and_embeddings_assets(ext_tree):
    """The styles asset (JAX's test) and, in the port, an extension's
    embeddings joining every model's database."""
    import torch

    from sdwebui_tpu.text.styles import StyleDatabase as JaxStyles
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.text.styles import StyleDatabase

    (ext_tree / "extensions" / "my-ext" / "styles.csv").write_text(
        "name,prompt,negative_prompt\nextstyle,masterpiece {prompt},bad\n")

    class FakeEngine:
        class sd_model:
            class conditioner:
                embedding_db = None

    ours = StyleDatabase(str(ext_tree / "styles.csv"))
    theirs = FakeEngine()
    theirs.styles = JaxStyles(str(ext_tree / "styles.csv"))
    assert ext_mod.load_extension_styles(ours) == ["my-ext"]
    assert jax_ext.load_extension_assets(theirs) == [("my-ext", "styles")]
    assert {k: vars(v) for k, v in ours.styles.items()} == \
        {k: vars(v) for k, v in theirs.styles.styles.items()}
    assert "extstyle" in ours.styles
    emb = ext_tree / "extensions" / "other-ext" / "embeddings"
    emb.mkdir()
    write_safetensors(str(emb / "extemb.safetensors"), {"emb_params": torch.ones(2, 64)})
    engine = Engine(device="cpu", tiny=True, styles_path=str(ext_tree / "styles.csv"),
                    embeddings_dir=str(ext_tree / "none"))
    assert "extstyle" in engine.styles.styles
    assert "extemb" in engine.sd_model.conditioner.embedding_db.embeddings
    engine.refresh_embeddings()
    assert "extemb" in engine.sd_model.conditioner.embedding_db.embeddings


# ---- policy-gated extension scripts ------------------------------------------

SCRIPT = '''\
# a third-party script written against the reference's script API
from modules import script_callbacks, scripts, shared


class WatermarkTag(scripts.Script):
    name = "sample watermark tag"
    ui_params = [{"name": "tag", "label": "Tag", "type": "text", "default": "sampled"}]

    def title(self):
        return "Sample watermark tag"

    def run(self, engine, p, tag="sampled", *rest):
        p.extra_generation_params["Watermark tag"] = tag
        return engine.txt2img_inner(p)


SEEN = {"saves": 0, "basedir": scripts.basedir(), "opts": shared.opts,
        "state": shared.state, "allow_code": getattr(shared.cmd_opts, "allow_code", None)}


def _on_image_saved(params):
    SEEN["saves"] += 1


script_callbacks.on_image_saved(_on_image_saved)
'''


@pytest.fixture()
def ext_with_script(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = tmp_path / "extensions" / "sample-extension"
    (root / "scripts").mkdir(parents=True)
    (root / "scripts" / "watermark_tag.py").write_text(SCRIPT)
    (root / "metadata.ini").write_text("[Extension]\nName = sample-extension\nRequires =\n")
    saved = list(framework._callbacks["image_saved"])
    yield tmp_path
    framework._SCRIPT_REGISTRY.pop("sample watermark tag", None)
    framework._callbacks["image_saved"][:] = saved
    opts.set("enable_extension_scripts", False)
    for name in [m for m in sys.modules if m.startswith("sdwebui_ext.")]:
        sys.modules.pop(name)


def test_extension_scripts_gated_off_by_default(ext_with_script):
    assert ext_mod.load_extension_scripts() == {}
    assert jax_ext.load_extension_scripts() == {}
    assert "sample watermark tag" not in framework.list_selectable_scripts()
    engine = Engine(device="cpu", tiny=True)
    assert engine.extension_scripts == {}
    status, out = Api(engine).handle("POST", "/sdapi/v1/txt2img", {
        "steps": 1, "width": 64, "height": 64, "script_name": "sample watermark tag"})
    assert status == 400 and "Script not found" in out["detail"]


@pytest.mark.parametrize("consent", ["option", "allow_code"])
def test_extension_script_loads_and_runs(ext_with_script, consent):
    """With consent the script registers through the reference's modules.*
    API (the shim, removed after loading), sees the Engine's state and
    flags, runs through /sdapi/v1/txt2img and its image_saved callback
    fires through the channel."""
    if consent == "option":
        opts.set("enable_extension_scripts", True)
    engine = Engine(device="cpu", tiny=True, allow_code=consent == "allow_code")
    assert engine.extension_scripts == {"sample-extension": ["watermark_tag.py"]}
    assert "sample watermark tag" in framework.list_selectable_scripts()
    mod = sys.modules.get("modules")
    assert mod is None or getattr(mod, "__sdtpu_compat__", False) is False
    ext_module = sys.modules["sdwebui_ext.sample_extension.watermark_tag"]
    assert ext_module.SEEN["basedir"].endswith(os.path.join("extensions", "sample-extension"))
    assert ext_module.SEEN["opts"] is opts and ext_module.SEEN["state"] is engine.state
    assert ext_module.SEEN["allow_code"] is (consent == "allow_code")
    status, out = Api(engine).handle("POST", "/sdapi/v1/txt2img", {
        "steps": 1, "width": 64, "height": 64, "script_name": "sample watermark tag",
        "script_args": ["tagged-by-ext"]})
    assert status == 200, out
    assert "Watermark tag: tagged-by-ext" in json.loads(out["info"])["infotexts"][0]
    before = ext_module.SEEN["saves"]
    framework.invoke("image_saved", None)
    assert ext_module.SEEN["saves"] == before + 1


def test_topo_sort_requires(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name, req in [("b-ext", "a-ext"), ("a-ext", ""), ("c-ext", "b-ext")]:
        d = tmp_path / "extensions" / name
        d.mkdir(parents=True)
        (d / "metadata.ini").write_text(f"[Extension]\nRequires = {req}\n")
    order = [e.name for e in ext_mod._topo_sort(ext_mod.list_extensions())]
    assert order.index("a-ext") < order.index("b-ext") < order.index("c-ext")
    assert order == [e.name for e in jax_ext._topo_sort(jax_ext.list_extensions())]


def _git_repo(src):
    (src / "scripts").mkdir(parents=True)
    (src / "scripts" / "cool.py").write_text("print('hi')\n")
    (src / "install.py").write_text("open('installed.txt', 'w').write('ran')\n")
    for cmd in (["git", "init", "-q"],
                ["git", "-c", "user.email=t@t", "-c", "user.name=t", "add", "."],
                ["git", "-c", "user.email=t@t", "-c", "user.name=t", "commit", "-qm", "init"]):
        subprocess.run(cmd, cwd=src, check=True, capture_output=True)


@pytest.mark.skipif(not HAS_GIT, reason="git is not installed")
def test_install_from_local_git(tmp_path, monkeypatch):
    """install_from_url clones a local repository into extensions/ (and a
    file:// remote), install.py runs only with allow_code, and the
    extension lists with its git metadata; re-install refuses."""
    src = tmp_path / "upstream" / "cool-ext"
    _git_repo(src)
    monkeypatch.chdir(tmp_path)
    ext = ext_mod.install_from_url(str(src))
    assert ext.name == "cool-ext" and len(ext.commit_hash) == 40 and ext.version
    assert (tmp_path / "extensions" / "cool-ext" / "scripts" / "cool.py").exists()
    assert not (tmp_path / "extensions" / "cool-ext" / "installed.txt").exists()
    assert "cool-ext" in [e.name for e in ext_mod.list_extensions()]
    with pytest.raises(FileExistsError):
        ext_mod.install_from_url(str(src))
    assert ext_mod.check_updates()["cool-ext"] in ("latest", "unknown")
    other = ext_mod.install_from_url(f"file://{src}", dirname="coded", allow_code=True)
    assert (tmp_path / "extensions" / "coded" / "installed.txt").read_text() == "ran"
    assert other.remote == f"file://{src}"
    # the routes over the same tree, and JAX's listing of it
    api = Api(Engine(device="cpu", tiny=True))
    listed = api.handle("GET", "/sdapi/v1/extensions", None)[1]
    assert [e["name"] for e in listed] == ["coded", "cool-ext"]
    assert listed[1]["commit_hash"] == ext.commit_hash and listed[1]["enabled"] is True
    jax_rows = []
    for e in jax_ext.list_extensions():
        e.read_info_from_repo()
        jax_rows.append((e.name, e.remote, e.branch, e.commit_hash, e.commit_date, e.version))
    assert [(e["name"], e["remote"], e["branch"], e["commit_hash"], e["commit_date"],
             e["version"]) for e in listed] == jax_rows
    status, out = api.handle("POST", "/internal/extensions/install",
                             {"url": str(src), "dirname": "third"})
    assert status == 200 and out["name"] == "third" and out["commit_hash"] == ext.commit_hash
    status, out = api.handle("POST", "/internal/extensions/install", {"url": str(src)})
    assert status == 400 and "already installed" in out["detail"]
    status, out = api.handle("POST", "/internal/extensions/check-updates", {})
    assert status == 200 and set(out) == {"coded", "cool-ext", "third"}


def test_extension_metadata_without_git(tmp_path, monkeypatch):
    """No git on PATH: the metadata stays empty and a clone refuses by name."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "extensions" / "plain" / ".git").mkdir(parents=True)
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    (ext,) = ext_mod.list_extensions()
    ext.read_info_from_repo()
    assert (ext.remote, ext.commit_hash, ext.version) == (None, "", "")
    with pytest.raises(RuntimeError, match="git is not installed"):
        ext_mod.install_from_url(str(tmp_path / "somewhere"), dirname="x")


@pytest.mark.parametrize("bad", ["../evil", "a/b", "..", ".hidden", "c\\d", "nul\0byte"])
def test_install_rejects_path_traversal(tmp_path, monkeypatch, bad):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError):
        ext_mod.install_from_url("/tmp/whatever", dirname=bad)
    with pytest.raises(ValueError):
        jax_ext.install_from_url("/tmp/whatever", dirname=bad)
    status, out = Api(Engine(device="cpu", tiny=True)).handle(
        "POST", "/internal/extensions/install", {"url": "/tmp/whatever", "dirname": bad})
    assert status == 400
    assert not os.path.exists(tmp_path / "extensions") or \
        os.listdir(tmp_path / "extensions") == []


# ---- the available-extensions index -------------------------------------------

INDEX = {
    "tags": {"script": "scripts", "tab": "adds a tab", "ads": "contains ads",
             "localization": "translations"},
    "extensions": [
        {"name": "alpha-tools", "url": "https://x/alpha-tools.git",
         "description": "alpha things", "added": "2023-01-02",
         "tags": ["script"], "stars": 50},
        {"name": "zeta-tab", "url": "https://x/zeta-tab.git",
         "description": "a zeta tab", "added": "2024-06-01",
         "tags": ["tab"], "stars": 900},
        {"name": "ad-thing", "url": "https://x/ad-thing",
         "description": "spam", "added": "2022-01-01", "tags": ["ads"]},
        {"name": "cool-ext", "url": "https://x/cool-ext.git",
         "description": "already installed locally", "added": "2023-05-05",
         "tags": ["script"], "stars": 10},
        {"name": "ja-pack", "url": "https://x/ja.git",
         "description": "japanese localization", "added": "2023-03-03",
         "tags": ["localization"]},
    ],
}


@pytest.fixture()
def index_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("extensions/cool-ext")  # installed by dir name
    p = tmp_path / "index.json"
    p.write_text(json.dumps(INDEX))
    monkeypatch.setattr(ext_mod, "_available_index", None)
    monkeypatch.setattr(jax_ext, "_available_index", None)
    return str(p)


BROWSE = [dict(), dict(sort_column=2), dict(sort_column=7), dict(sort_column=1),
          dict(selected_tags=["tab"]), dict(filter_text="alpha things"),
          dict(hide_installed=False), dict(selected_tags=["installed"]),
          dict(selected_tags=["localization"], sort_column=3)]


def test_browse_available_equals_jax(index_file):
    ext_mod.load_available_index(index_file)
    jax_ext.load_available_index(index_file)
    for kw in BROWSE:
        assert ext_mod.browse_available(**kw) == jax_ext.browse_available(**kw), kw
    got = ext_mod.browse_available()
    names = [e["name"] for e in got["extensions"]]
    assert "ad-thing" not in names and "ja-pack" not in names and "cool-ext" not in names
    assert got["hidden"] == 3 and names.index("zeta-tab") < names.index("alpha-tools")
    allx = ext_mod.browse_available(hide_installed=False)["extensions"]
    assert next(e for e in allx if e["name"] == "cool-ext")["installed"] is True


def test_browse_available_requires_index(monkeypatch):
    monkeypatch.setattr(ext_mod, "_available_index", None)
    with pytest.raises(ValueError):
        ext_mod.browse_available()


def test_available_endpoint(index_file, monkeypatch):
    """POST /internal/extensions/available with a local index path, then
    re-filtered without re-reading; an index URL to a loopback host is
    refused before any connection."""
    from sdwebui_tpu_torch.utils import url_fetch

    api = Api(Engine(device="cpu", tiny=True))
    got = api.handle("POST", "/internal/extensions/available",
                     {"url": index_file, "refresh": True})[1]
    assert {"alpha-tools", "zeta-tab"} <= {e["name"] for e in got["extensions"]}
    got2 = api.handle("POST", "/internal/extensions/available", {"search": "zeta"})[1]
    assert [e["name"] for e in got2["extensions"]] == ["zeta-tab"]
    status, _ = api.handle("POST", "/internal/extensions/available",
                           {"url": "/no/such/index.json", "refresh": True})
    assert status == 400
    monkeypatch.setattr(url_fetch, "open_socket", lambda *a: pytest.fail("connected"))
    status, out = api.handle("POST", "/internal/extensions/available",
                             {"url": "http://127.0.0.1:1/index.json", "refresh": True})
    assert status == 400 and "local resource" in out["detail"]


def test_localization_from_an_extension(ext_tree):
    loc = ext_tree / "extensions" / "my-ext" / "localizations"
    loc.mkdir()
    (loc / "de.json").write_text(json.dumps({"Generate": "Erzeugen"}))
    api = Api(Engine(device="cpu", tiny=True))
    with opts.override({"localization": "de"}):
        assert api.handle("GET", "/internal/localization", None) == (
            200, {"Generate": "Erzeugen"})
        opts.set("disabled_extensions", ["my-ext"])
        assert api.handle("GET", "/internal/localization", None) == (200, {})


def test_compat_shim_maps_the_callbacks_of_jax():
    """The shim's callback aliases are JAX's, each onto a channel the
    port's framework holds; the shim leaves sys.modules as it found it."""
    from sdwebui_tpu.scripts import compat as jax_compat
    from sdwebui_tpu_torch.scripts import compat

    assert compat._CALLBACK_ALIASES == jax_compat._CALLBACK_ALIASES
    assert set(compat._CALLBACK_ALIASES.values()) <= set(framework.CALLBACK_CHANNELS)
    before = {k: sys.modules.get(k) for k in ("modules", "modules.scripts")}
    state = types.SimpleNamespace()
    with compat.shim_installed("/ext/path", state=state):
        import modules.scripts
        import modules.shared

        assert modules.scripts.basedir() == "/ext/path" and modules.shared.state is state
        assert modules.scripts.Script is framework.Script
    assert {k: sys.modules.get(k) for k in before} == before


@pytest.mark.parametrize("url, branch", [
    ("--template=extensions/evil", None), ("-c", None),
    ("http://127.0.0.1/x.git", None), ("https://example.com/ext.git", None),
    ("git@example.com:ext.git", None), ("ext::sh -c touch% /tmp/pwned", None),
    ("/tmp/whatever", "--upload-pack=touch")])
def test_install_refuses_options_and_remotes(tmp_path, monkeypatch, url, branch):
    """A URL git would read as an option, a network remote, a transport
    address or a branch that starts with '-': 400, and git never runs."""
    monkeypatch.chdir(tmp_path)

    def no_git(*a, **k):
        raise AssertionError(f"git ran: {a}")
    monkeypatch.setattr(ext_mod.subprocess, "run", no_git)
    with pytest.raises(ValueError):
        ext_mod.install_from_url(url, dirname="x", branch=branch)
    status, out = Api(Engine(device="cpu", tiny=True)).handle(
        "POST", "/internal/extensions/install", {"url": url, "dirname": "x", "branch": branch})
    assert status == 400, out
    assert not os.path.exists(tmp_path / "extensions")
