"""The custom-UNet slot — port of ``sdwebui_tpu/pipeline/sd_unet.py``
(the reference's modules/sd_unet.py:63-93).

A provider does not patch a live module's forward: it returns the model
bundle to generate with (``dataclasses.replace(model, unet=...)``), and
never mutates the one it is given.  Extensions register providers on the
``list_unets`` callback channel, as in the reference; ``opts.sd_unet``
picks one by label ("Automatic" and "None": the checkpoint's own UNet).
An unknown label logs a warning once and keeps the checkpoint's UNet, as
JAX warns and keeps it.
"""

from __future__ import annotations

import logging
from typing import Callable, List

from sdwebui_tpu_torch.scripts import framework
from sdwebui_tpu_torch.utils.options import opts

log = logging.getLogger(__name__)


class SdUnetOption:
    """One selectable UNet provider: `label` names it among the sd_unet
    choices; ``apply_to(model)`` returns the model to generate with."""

    label: str = ""

    def __init__(self, label: str | None = None, apply_fn: Callable | None = None):
        if label is not None:
            self.label = label
        self._apply_fn = apply_fn

    def apply_to(self, model):
        if self._apply_fn is None:
            raise NotImplementedError
        return self._apply_fn(model)


_options: List[SdUnetOption] = []
_UNKNOWN_LOGGED: set = set()


def refresh_unet_list() -> List[SdUnetOption]:
    """Collect the providers from the list_unets callbacks: a callback may
    append to the list it is passed (the reference's way) or return
    option(s)."""
    _options.clear()
    for res in framework.invoke("list_unets", _options):
        if isinstance(res, SdUnetOption):
            _options.append(res)
        elif isinstance(res, (list, tuple)):
            _options.extend(r for r in res if isinstance(r, SdUnetOption))
    return list(_options)


def unet_labels() -> List[str]:
    return ["Automatic", "None"] + [o.label for o in _options]


def resolve(model):
    """The model of opts.sd_unet's provider (the model itself for
    Automatic, None and an unknown label)."""
    name = str(opts.get("sd_unet", "Automatic"))
    if name in ("Automatic", "None", ""):
        return model
    refresh_unet_list()
    for o in _options:
        if o.label == name:
            return o.apply_to(model)
    if name not in _UNKNOWN_LOGGED:
        _UNKNOWN_LOGGED.add(name)
        log.warning("sd_unet: no provider named %r; using the checkpoint's UNet", name)
    return model
