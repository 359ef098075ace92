"""Compatibility shim for third-party extension scripts.

Port of ``sdwebui_tpu/scripts/compat.py`` over the port's
``scripts/framework``.  Extensions written for the reference import its
module namespace (``modules.scripts``, ``modules.script_callbacks``,
``modules.shared``); the shim maps the script-API subset of it:

  modules.scripts.Script            -> scripts.framework.Script
  modules.scripts.basedir()         -> the loading extension's path
  modules.script_callbacks.on_*     -> the framework's callback channels
  modules.shared.opts / state / cmd_opts

It sits in ``sys.modules`` only while an extension script executes
(``shim_installed``), and whatever held the ``modules`` names before is
put back after.
"""

from __future__ import annotations

import contextlib
import sys
import types

_CALLBACK_ALIASES = {
    "on_app_started": "app_started",
    "on_model_loaded": "model_loaded",
    "on_ui_tabs": "ui_tabs",
    "on_ui_settings": "ui_settings",
    "on_before_ui": "before_ui",
    "on_image_saved": "image_saved",
    "on_before_image_saved": "before_image_saved",
    "on_cfg_denoiser": "cfg_denoiser",
    "on_cfg_denoised": "cfg_denoised",
    "on_cfg_after_cfg": "cfg_after_cfg",
    "on_extra_noise": "extra_noise",
    "on_infotext_pasted": "infotext_pasted",
    "on_script_unloaded": "script_unloaded",
    "on_list_optimizers": "list_optimizers",
    "on_before_token_counter": "before_token_counter",
    "on_image_grid": "image_grid",
    "on_mask_blend": "mask_blend",
    "on_before_process": "before_process",
    "on_after_extra_networks_activate": "after_extra_networks_activate",
}


def build_shim(extension_path: str = "", state=None, cmd_opts=None) -> dict:
    """sys.modules entries emulating the reference's script-facing API;
    `state` and `cmd_opts` become ``modules.shared``'s (the Engine's job
    state and the server's flags)."""
    from sdwebui_tpu_torch.scripts import framework
    from sdwebui_tpu_torch.utils.options import opts

    root = types.ModuleType("modules")
    root.__path__ = []              # behave like a package
    root.__sdtpu_compat__ = True    # lets tests assert the shim was removed

    m_scripts = types.ModuleType("modules.scripts")
    m_scripts.Script = framework.Script
    m_scripts.basedir = lambda: extension_path
    m_scripts.AlwaysVisible = object()      # reference sentinel for show()
    m_scripts.PostprocessImageArgs = framework.PostprocessImageArgs

    m_callbacks = types.ModuleType("modules.script_callbacks")
    for alias, channel in _CALLBACK_ALIASES.items():
        setattr(m_callbacks, alias, (lambda ch: lambda fn: framework.on(ch, fn))(channel))
    m_callbacks.remove_current_script_callbacks = framework.remove_current_script_callbacks
    m_callbacks.ImageSaveParams = framework.ImageSaveParams

    m_shared = types.ModuleType("modules.shared")
    m_shared.opts = opts
    m_shared.cmd_opts = cmd_opts if cmd_opts is not None else types.SimpleNamespace()
    m_shared.state = state

    root.scripts = m_scripts
    root.script_callbacks = m_callbacks
    root.shared = m_shared
    return {
        "modules": root,
        "modules.scripts": m_scripts,
        "modules.script_callbacks": m_callbacks,
        "modules.shared": m_shared,
    }


@contextlib.contextmanager
def shim_installed(extension_path: str = "", state=None, cmd_opts=None):
    entries = build_shim(extension_path, state, cmd_opts)
    saved = {k: sys.modules.get(k) for k in entries}
    sys.modules.update(entries)
    try:
        yield
    finally:
        for k, prev in saved.items():
            if prev is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = prev
