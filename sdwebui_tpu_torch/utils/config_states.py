"""Config-state snapshots (reference modules/config_states.py).

Port of ``sdwebui_tpu/utils/config_states.py``: JSON files under
``config_states/`` recording the web UI's git commit and every extension's
name, remote, branch, commit and enabled flag, so a known-good setup can
be listed and applied again.  Restoring applies the enabled set (the
``disabled_extensions`` option); git checkouts are left to the user, as
in JAX.  ``server/__main__`` applies ``restore_config_state_file`` once at
start.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

from sdwebui_tpu_torch.extensions import list_extensions
from sdwebui_tpu_torch.utils.options import opts

CONFIG_STATES_DIR = "config_states"


def _webui_info() -> dict:
    def git(*args):
        try:
            return subprocess.run(["git", *args], capture_output=True,
                                  text=True, timeout=5).stdout.strip()
        except Exception:
            return ""

    return {"remote": git("config", "--get", "remote.origin.url") or None,
            "commit_hash": git("rev-parse", "HEAD"),
            "branch": git("rev-parse", "--abbrev-ref", "HEAD")}


def get_config() -> dict:
    exts = {}
    for e in list_extensions():
        e.read_info_from_repo()
        exts[e.name] = {"name": e.name, "path": e.path, "enabled": e.enabled,
                        "is_builtin": e.is_builtin, "remote": e.remote,
                        "branch": e.branch, "commit_hash": e.commit_hash,
                        "commit_date": e.commit_date}
    return {"created_at": time.time(), "webui": _webui_info(),
            "extensions": exts}


def save_config_state(name: str = "Config", dirpath: str = CONFIG_STATES_DIR) -> str:
    os.makedirs(dirpath, exist_ok=True)
    state = get_config()
    state["name"] = name
    ts = time.strftime("%Y_%m_%d-%H_%M_%S")
    path = os.path.join(dirpath, f"{ts}_{name}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(state, f, indent=4)
    return path


def list_config_states(dirpath: str = CONFIG_STATES_DIR) -> list:
    if not os.path.isdir(dirpath):
        return []
    out = []
    for fn in os.listdir(dirpath):
        if not fn.endswith(".json"):
            continue
        path = os.path.join(dirpath, fn)
        try:
            with open(path, encoding="utf-8") as f:
                j = json.load(f)
            assert "created_at" in j
            j["filepath"] = path
            out.append(j)
        except Exception:
            continue
    return sorted(out, key=lambda cs: cs["created_at"], reverse=True)


def restore_extension_config(state: dict):
    """Re-apply the enabled/disabled set from a saved state (reference
    restore_extension_config; git resets are not done)."""
    disabled = [name for name, info in state.get("extensions", {}).items()
                if not info.get("enabled", True)]
    opts.set("disabled_extensions", disabled)
    return disabled


def restore_config_state_file(config_path: str | None = None) -> str | None:
    """opts.restore_config_state_file applied once (JAX's
    ``__main__.py:84-101``): the saved state's enabled set, then the
    option cleared and, with `config_path`, the options saved there.
    Returns the file applied, or None.  A state that cannot be read is
    reported and cleared all the same."""
    path = opts.get("restore_config_state_file", "")
    if not path:
        return None
    try:
        with open(path, encoding="utf-8") as f:
            restore_extension_config(json.load(f))
        print(f"restored config state from {path}", flush=True)
    except Exception as e:
        print(f"could not restore config state {path!r}: {e}", flush=True)
        path = None
    opts.set("restore_config_state_file", "")
    if config_path:
        opts.save(config_path)
    return path
