"""Extensions manager (reference modules/extensions.py).

Port of ``sdwebui_tpu/extensions.py``: extensions are the directories of
``extensions/`` (user) and ``extensions-builtin/`` (shipped), relative to
the working directory; git metadata is read when one is a git checkout
(best effort: none without ``git``); the options' disable policy applies
(``disabled_extensions``, ``disable_all_extensions`` none | extra | all).

Extension code does not run by default: only the declarative assets load
(each enabled extension's ``styles.csv`` and ``embeddings/``).  Its
``scripts/*.py`` run, under the compatibility shim
(``scripts/compat.py``), only with ``--allow-code`` or the
``enable_extension_scripts`` option; so does an installed extension's
``install.py``.  ``install_from_url`` clones with ``git`` from a local path
or a ``file://`` remote only (``check_source``), into a directory whose name
must be one path component.  The available-extensions index is read from a local
JSON file, or fetched through ``utils/url_fetch`` (global hosts only).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import logging
import os
import subprocess
import sys

from sdwebui_tpu_torch.utils.options import opts

log = logging.getLogger(__name__)

DEFAULT_DIRS = ("extensions", "extensions-builtin")


@dataclasses.dataclass
class Extension:
    name: str
    path: str
    enabled: bool = True
    is_builtin: bool = False
    remote: str | None = None
    branch: str = ""
    commit_hash: str = ""
    commit_date: int = 0
    version: str = ""

    def read_info_from_repo(self):
        """git metadata, best effort (reference Extension.read_info_from_repo)."""
        if not os.path.isdir(os.path.join(self.path, ".git")):
            return

        def git(*args):
            try:
                return subprocess.run(
                    ["git", "-C", self.path, *args], capture_output=True,
                    text=True, timeout=5).stdout.strip()
            except Exception:
                return ""

        self.remote = git("config", "--get", "remote.origin.url") or None
        head = git("rev-parse", "HEAD")
        if not all(c in "0123456789abcdef" for c in head) or len(head) != 40:
            return   # repo without commits: keep empty metadata
        self.commit_hash = head
        self.branch = git("rev-parse", "--abbrev-ref", "HEAD")
        date = git("log", "-1", "--format=%ct")
        self.commit_date = int(date) if date.isdigit() else 0
        self.version = head[:8]


def list_extensions(dirs=DEFAULT_DIRS) -> list:
    """Discover extensions and apply the options disable policy."""
    disable_all = opts.get("disable_all_extensions", "none")
    disabled = set(opts.get("disabled_extensions", []) or [])
    out = []
    for d in dirs:
        if not os.path.isdir(d):
            continue
        builtin = d.endswith("-builtin")
        for name in sorted(os.listdir(d)):
            path = os.path.join(d, name)
            if not os.path.isdir(path) or name.startswith("."):
                continue
            enabled = name not in disabled
            if disable_all == "all":
                enabled = False
            elif disable_all == "extra" and not builtin:
                enabled = False
            out.append(Extension(name=name, path=path, enabled=enabled,
                                 is_builtin=builtin))
    return out


def active_extensions(dirs=DEFAULT_DIRS) -> list:
    return [e for e in list_extensions(dirs) if e.enabled]


def _topo_sort(exts: list) -> list:
    """Stable topological order honoring metadata.ini [Extension] Requires
    (reference modules/extensions.py:228 ExtensionMetadata + scripts.py
    topological_sort)."""
    import configparser

    requires = {}
    for ext in exts:
        reqs = []
        meta = os.path.join(ext.path, "metadata.ini")
        if os.path.isfile(meta):
            cp = configparser.ConfigParser()
            try:
                cp.read(meta)
                raw = cp.get("Extension", "Requires", fallback="")
                reqs = [r.strip() for r in raw.split(",") if r.strip()]
            except configparser.Error:
                pass
        requires[ext.name] = reqs
    by_name = {e.name: e for e in exts}
    done, out = set(), []

    def visit(name, chain=()):
        if name in done or name not in by_name or name in chain:
            return
        for req in requires.get(name, []):
            visit(req, chain + (name,))
        done.add(name)
        out.append(by_name[name])

    for ext in exts:
        visit(ext.name)
    return out


def load_extension_scripts(dirs=DEFAULT_DIRS, allow: bool | None = None, state=None,
                           cmd_opts=None) -> dict:
    """Execute the enabled extensions' ``scripts/*.py`` through the Script
    framework (reference modules/scripts.py:487 load_scripts), under the
    compat shim (``modules.scripts``, ``modules.script_callbacks``,
    ``modules.shared`` with `state` and `cmd_opts`).  Only with consent:
    `allow` (``--allow-code``) or the ``enable_extension_scripts`` option.
    Script subclasses a file defines register themselves.  Returns
    {extension: [script files]} for what loaded; a file that raises is
    logged with its traceback and skipped."""
    from sdwebui_tpu_torch.scripts.compat import shim_installed
    from sdwebui_tpu_torch.scripts.framework import _SCRIPT_REGISTRY, Script, register_script

    if not (allow or opts.get("enable_extension_scripts", False)):
        return {}
    loaded: dict[str, list] = {}
    for ext in _topo_sort(active_extensions(dirs)):
        script_dir = os.path.join(ext.path, "scripts")
        if not os.path.isdir(script_dir):
            continue
        for fn in sorted(os.listdir(script_dir)):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(script_dir, fn)
            mod_name = f"sdwebui_ext.{ext.name}.{fn[:-3]}".replace("-", "_")
            try:
                before = set(_SCRIPT_REGISTRY.values())
                with shim_installed(ext.path, state=state, cmd_opts=cmd_opts):
                    spec = importlib.util.spec_from_file_location(mod_name, path)
                    module = importlib.util.module_from_spec(spec)
                    sys.modules[mod_name] = module
                    spec.loader.exec_module(module)
                # register the Script subclasses the file defined but did not
                # register itself (the reference collects them by scan)
                for obj in vars(module).values():
                    if isinstance(obj, type) and issubclass(obj, Script) and obj is not Script \
                            and obj not in before and obj not in _SCRIPT_REGISTRY.values():
                        if getattr(obj, "name", None) in (None, "base"):
                            obj.name = getattr(obj(), "title", lambda: fn[:-3])() or fn[:-3]
                        register_script(obj)
                loaded.setdefault(ext.name, []).append(fn)
            except Exception:
                log.exception("error loading extension script %s", path)
    return loaded


def load_extension_styles(styles, dirs=DEFAULT_DIRS) -> list:
    """Each enabled extension's ``styles.csv`` merged into `styles` (a
    StyleDatabase); the extensions' names."""
    loaded = []
    for ext in active_extensions(dirs):
        path = os.path.join(ext.path, "styles.csv")
        if os.path.isfile(path):
            styles.load_extra(path)
            loaded.append(ext.name)
    return loaded


def load_extension_embeddings(model, dirs=DEFAULT_DIRS) -> list:
    """Each enabled extension's ``embeddings/`` loaded into `model`'s
    embedding database; the extensions' names."""
    db = getattr(model.conditioner, "embedding_db", None)
    loaded = []
    for ext in active_extensions(dirs):
        path = os.path.join(ext.path, "embeddings")
        if db is not None and os.path.isdir(path):
            db.load_from_dir(path)
            loaded.append(ext.name)
    return loaded


def check_dirname(name: str) -> str:
    """An extension directory name: one path component, not hidden."""
    if name in (".", "..") or any(c in name for c in ("/", "\\", "\0")) or name.startswith("."):
        raise ValueError(f"invalid extension directory name {name!r}")
    return name


def check_source(url: str) -> str:
    """An extension's source: a local path or a ``file://`` URL.  JAX clones
    any URL, which lets a request make the server fetch from its own network
    or, with a URL that git reads as an option, run a hook; the port refuses
    a network remote, a ``<transport>::`` or ``host:path`` address and a
    leading ``-``."""
    if not url:
        raise ValueError("empty extension URL")
    if url.startswith("-"):
        raise ValueError(f"invalid extension URL {url!r}")
    if not url.startswith("file://") and ":" in url.split("/", 1)[0]:
        raise ValueError(f"only a local path or a file:// URL can be installed, not {url!r}")
    return url


def install_from_url(url: str, dirname: str | None = None, branch: str | None = None,
                     target_root: str = "extensions", allow_code: bool = False) -> Extension:
    """Install an extension by ``git clone`` (reference
    modules/ui_extensions.py install_extension_from_url): a local path or a
    file:// remote needs no network.  The extension's install.py runs only
    with `allow_code` (``--allow-code``): it is third-party code."""
    check_source(url)
    if branch and branch.startswith("-"):
        raise ValueError(f"invalid branch name {branch!r}")
    name = dirname or os.path.basename(url.rstrip("/")).removesuffix(".git")
    if not name:
        raise ValueError(f"cannot derive extension name from {url!r}")
    check_dirname(name)
    target = os.path.join(target_root, name)
    if os.path.exists(target):
        raise FileExistsError(f"Extension with this name is already installed: {name}")
    os.makedirs(target_root, exist_ok=True)
    tmp = target + ".tmp"
    cmd = ["git", "clone", "--depth", "1"]
    if branch:
        cmd += ["-b", branch]
    cmd += ["--", url, tmp]
    try:
        subprocess.run(cmd, capture_output=True, text=True, timeout=120, check=True)
    except FileNotFoundError as e:
        raise RuntimeError("git is not installed") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"git clone failed: {e.stderr.strip()}") from e
    os.rename(tmp, target)
    install_py = os.path.join(target, "install.py")
    if os.path.isfile(install_py) and allow_code:
        subprocess.run([sys.executable, os.path.abspath(install_py)], capture_output=True,
                       text=True, timeout=600, cwd=target)
    ext = Extension(name=name, path=target)
    ext.read_info_from_repo()
    return ext


def check_updates(dirs=("extensions",)) -> dict:
    """git fetch + behind-count per extension (reference
    Extension.check_updates); returns {name: 'latest'|'behind N'|'unknown'}."""
    out = {}
    for ext in list_extensions(dirs):
        if not os.path.isdir(os.path.join(ext.path, ".git")):
            out[ext.name] = "unknown"
            continue
        try:
            subprocess.run(["git", "-C", ext.path, "fetch", "--quiet"],
                           capture_output=True, timeout=30)
            r = subprocess.run(
                ["git", "-C", ext.path, "rev-list", "--count",
                 "HEAD..@{upstream}"], capture_output=True, text=True,
                timeout=10)
            n = r.stdout.strip()
            out[ext.name] = "latest" if n == "0" else \
                (f"behind {n}" if n.isdigit() else "unknown")
        except Exception:
            out[ext.name] = "unknown"
    return out


# ---- the available-extensions index (reference ui_extensions.py:407) -----

DEFAULT_INDEX_URL = ("https://raw.githubusercontent.com/AUTOMATIC1111/"
                     "stable-diffusion-webui-extensions/master/index.json")

_available_index: dict | None = None

# reference sort_ordering (ui_extensions.py:434-443), by dropdown position
_SORT_KEYS = [
    ("added", True), ("added", False), ("name", False), ("name", True),
    (None, False), ("commit_time", True), ("created_at", True),
    ("stars", True),
]


def load_available_index(url_or_path: str | None = None) -> dict:
    """Read and cache the extensions catalog: {"tags": {tag: description},
    "extensions": [{"name", "url", "description", "added", "tags", ...}]},
    from a local JSON file or an http(s) URL (``utils/url_fetch``)."""
    global _available_index

    src = url_or_path or DEFAULT_INDEX_URL
    if src.startswith(("http://", "https://")):
        from sdwebui_tpu_torch.utils.url_fetch import fetch

        data = json.loads(fetch(src, timeout=20))
    else:
        with open(src, encoding="utf-8") as f:
            data = json.load(f)
    if not isinstance(data.get("extensions"), list):
        raise ValueError("index has no 'extensions' list")
    _available_index = {"tags": dict(data.get("tags") or {}),
                        "extensions": data["extensions"]}
    return _available_index


def _normalize_git_url(url):
    if not url:
        return None
    return url.removesuffix(".git")


def browse_available(selected_tags=(), filter_text: str = "",
                     sort_column: int = 0, hide_installed: bool = True,
                     hide_tags=("ads", "localization", "installed"),
                     dirs=DEFAULT_DIRS) -> dict:
    """Filter/sort the cached index the way the reference's Available tab
    does: tag whitelist (selected), tag blacklist (hide), substring search
    over name+description, installed detection by dir name or git remote.

    Returns {"tags": {...}, "extensions": [row...], "hidden": n} with each
    row carrying an `installed` flag for the UI's Install button state."""
    if _available_index is None:
        raise ValueError("no index loaded — call load_available_index first")
    installed = list_extensions(dirs)
    installed_names = {e.name for e in installed}
    installed_urls = {_normalize_git_url(getattr(e, "remote", None))
                      for e in installed} - {None}

    selected = set(selected_tags or ())
    hidden_tags = set(hide_tags or ()) - selected
    needle = (filter_text or "").strip().lower()
    rows, hidden = [], 0
    for info in _available_index["extensions"]:
        ext_tags = set(info.get("tags") or [])
        name = info.get("name") or ""
        is_installed = (name in installed_names
                        or _normalize_git_url(info.get("url"))
                        in installed_urls)
        keep = True
        if selected and not (ext_tags & selected):
            keep = False
        if ext_tags & hidden_tags:
            keep = False
        if is_installed and hide_installed and "installed" not in selected:
            keep = False
        if needle and needle not in (name + " "
                                     + (info.get("description") or "")).lower():
            keep = False
        if not keep:
            hidden += 1
            continue
        rows.append({**info, "installed": is_installed})

    key, reverse = _SORT_KEYS[sort_column % len(_SORT_KEYS)]
    if key is not None:
        default = 0 if key == "stars" else "z"
        rows.sort(key=lambda r: r.get(key) or default, reverse=reverse)
    return {"tags": _available_index["tags"], "extensions": rows,
            "hidden": hidden}
