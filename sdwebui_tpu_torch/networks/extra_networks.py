"""``<lora:name:mult>`` / ``<hypernet:name:mult>`` prompt tags and the
per-generation activation of extra networks.

Port of ``sdwebui_tpu/networks/extra_networks.py``.  Tags are stripped
from the prompt before tokenization (the infotext keeps them).  A LoRA set
becomes a merged copy of the model: new modules that hold new tensors for
the patched parameters and share every other parameter with the base
(``apply_to_model``).  The base's modules are never written, so a tagless
request after tagged ones sees the base weights bit for bit.  The merged
modules are cached on the base model per tag set and dropped whenever the
model moves (``SDModel.to``): a merged copy is never parked, switched or
written out as the checkpoint.

The LoRA and hypernetwork registries are the process's: ``set_lora_dirs``
and ``hypernetwork.set_hypernetwork_dirs`` point them at directories (the
server's ``--lora-dir`` and ``--hypernetwork-dir``).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re

from torch import nn

from sdwebui_tpu_torch.loader.registry import _visible
from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict
from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_checkpoint
from sdwebui_tpu_torch.networks import NetworkNotFound, hypernetwork
from sdwebui_tpu_torch.networks.lora import apply_loras
from sdwebui_tpu_torch.networks.textual_inversion import Embedding, as_rows
from sdwebui_tpu_torch.utils.options import opts

_RE_NETWORK = re.compile(r"<(\w+):([^>]+)>")

#: where LoRA / LyCORIS files live unless the caller says otherwise
DEFAULT_LORA_DIRS = (os.path.join("models", "Lora"), os.path.join("models", "LyCORIS"))

#: merged module sets kept per base model before the cache starts over
MERGE_CACHE_SIZE = 5


@dataclasses.dataclass
class ExtraNetworkParams:
    kind: str
    items: list

    @property
    def name(self) -> str:
        return self.items[0] if self.items else ""

    def mult(self, index: int = 1, default: float = 1.0) -> float:
        try:
            return float(self.items[index])
        except (IndexError, ValueError):
            return default


def parse_prompt(prompt: str):
    """prompt → (the prompt without tags, [ExtraNetworkParams])."""
    found = []

    def strip(m):
        found.append(ExtraNetworkParams(m.group(1), [x.strip() for x in m.group(2).split(":")]))
        return ""

    return _RE_NETWORK.sub(strip, prompt), found


class LoraRegistry:
    """The ``.safetensors`` / ``.pt`` / ``.ckpt`` files under `dirs`, by file
    stem."""

    def __init__(self, dirs=DEFAULT_LORA_DIRS):
        self.dirs = list(dirs)
        self.files: dict[str, str] = {}
        self.refresh()

    def refresh(self):
        self.files = {}
        for d in self.dirs:
            if not os.path.isdir(d):
                continue
            for root, _, files in os.walk(d):
                for fn in sorted(files):
                    path = os.path.join(root, fn)
                    if fn.lower().endswith((".safetensors", ".pt", ".ckpt")) and _visible(path):
                        self.files[os.path.splitext(fn)[0]] = path

    def path(self, name: str) -> str:
        path = self.files.get(name)
        if path is None:
            raise NetworkNotFound(f"LoRA {name!r} not found in {self.dirs}")
        return path

    def load(self, name: str) -> dict:
        path = self.path(name)
        return read_state_dict(path) if path.endswith(".safetensors") \
            else load_torch_checkpoint(path)


_lora_registry: LoraRegistry | None = None


def lora_registry() -> LoraRegistry:
    global _lora_registry
    if _lora_registry is None:
        _lora_registry = LoraRegistry()
    return _lora_registry


def set_lora_dirs(dirs) -> LoraRegistry:
    """Point the process's LoRA registry at `dirs` (scanned now)."""
    global _lora_registry
    _lora_registry = LoraRegistry(dirs)
    return _lora_registry


def activate(model, prompt: str, registry: LoraRegistry | None = None):
    """Parse and strip the tags → (clean prompt, model, hypernetwork).

    model: the base, or a merged copy for a LoRA set; hypernetwork: None
    or a ``hypernetwork.Hypernetwork`` at its multiplier, on the model's
    device.  Without a ``<hypernet:...>`` tag, opts.sd_hypernetwork adds
    one implicitly."""
    clean, nets = parse_prompt(prompt)
    for net in nets:
        if net.kind not in ("lora", "lyco", "hypernet"):
            raise NotImplementedError(f"extra network <{net.kind}:...> is not ported "
                                      "(lora, lyco and hypernet are)")
    lora_nets = [n for n in nets if n.kind in ("lora", "lyco")]
    hn_nets = [n for n in nets if n.kind == "hypernet"]
    default_mult = float(opts.get("extra_networks_default_multiplier", 1.0))
    if not hn_nets:
        implicit = opts.get("sd_hypernetwork", "None")
        if implicit and implicit != "None":
            hn_nets = [ExtraNetworkParams("hypernet", [str(implicit)])]
    hypernet = None
    if hn_nets:
        net = hn_nets[0]
        hypernet = hypernetwork.hypernet_registry().load(net.name, model.device) \
            .with_multiplier(net.mult(1, default_mult))
    if lora_nets:
        model = apply_to_model(model, lora_nets, registry or lora_registry())
    return clean, model, hypernet


def register_bundle_embeddings(model, lora_sd: dict) -> int:
    """Textual-inversion embeddings bundled in a kohya LoRA file
    (``bundle_emb.<name>.<tensor>``) join the model's embedding database,
    so their trigger words work once the LoRA is active."""
    db = model.conditioner.embedding_db
    if db is None:
        return 0
    bundles: dict = {}
    for k, v in lora_sd.items():
        if k.startswith("bundle_emb."):
            name, tensor_key = k[len("bundle_emb."):].split(".", 1)
            bundles.setdefault(name, {})[tensor_key] = v
    for name, tensors in bundles.items():
        if name in db.embeddings:
            continue
        if "clip_l" in tensors:     # SDXL dual embedding
            emb = Embedding(name, as_rows(tensors["clip_l"]), vec_g=as_rows(tensors["clip_g"]))
        else:
            key = "emb_params" if "emb_params" in tensors else \
                ("string_to_param.*" if "string_to_param.*" in tensors else next(iter(tensors)))
            emb = Embedding(name, as_rows(tensors[key]))
        db.register(emb)
    return len(bundles)


def _patched_copy(module: nn.Module, patched: dict) -> nn.Module:
    """A copy of `module` that shares every parameter except the `patched`
    names, which hold the given tensors."""
    if not patched:
        return module
    memo = {id(t): t for t in (*module.parameters(), *module.buffers())}
    clone = copy.deepcopy(module, memo)
    for name, t in patched.items():
        owner, _, leaf = name.rpartition(".")
        setattr(clone.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    return clone


def _merge(model, nets: list, registry: LoraRegistry) -> tuple:
    """(unet, CLIP, second CLIP) modules with every LoRA of `nets` merged."""
    default_mult = float(opts.get("extra_networks_default_multiplier", 1.0))
    loras_unet, loras_te = [], []
    for net in nets:
        sd = registry.load(net.name)
        register_bundle_embeddings(model, sd)
        te_mult = net.mult(1, default_mult)
        loras_unet.append((sd, net.mult(2, te_mult)))
        loras_te.append((sd, te_mult))
    unet_patch, _, _ = apply_loras(dict(model.unet.named_parameters()), loras_unet, "lora_unet_",
                                   hp=model.unet_hp)
    clip = model.conditioner.model
    clip_params = dict(clip.named_parameters())
    te_patch, n_te, _ = apply_loras(clip_params, loras_te, "lora_te_")
    if n_te == 0:
        te_patch, _, _ = apply_loras(clip_params, loras_te, "lora_te1_")
    clip2 = model.conditioner2.model if model.conditioner2 is not None else None
    te2_patch = {}
    if clip2 is not None:       # SDXL's bigG (kohya lora_te2_)
        te2_patch, _, _ = apply_loras(dict(clip2.named_parameters()), loras_te, "lora_te2_")
    return (_patched_copy(model.unet, unet_patch), _patched_copy(clip, te_patch),
            None if clip2 is None else _patched_copy(clip2, te2_patch))


def apply_to_model(model, nets: list, registry: LoraRegistry):
    """A copy of `model` with the ``<lora:name:te_mult[:unet_mult]>`` tags of
    `nets` merged (one multiplier applies to both).  The merged modules are
    cached on `model` by tag set and file; the same set twice merges once."""
    default_mult = float(opts.get("extra_networks_default_multiplier", 1.0))
    key = (default_mult, tuple((n.kind, tuple(n.items), _file_id(registry.path(n.name)))
                               for n in nets))
    cache = model.network_cache
    if key not in cache:
        if len(cache) >= MERGE_CACHE_SIZE:
            cache.clear()
        cache[key] = _merge(model, nets, registry)
    unet, clip, clip2 = cache[key]
    cond, cond2 = model.conditioner, model.conditioner2
    if clip is not cond.model:
        cond = copy.copy(cond)
        cond.model = clip
    if cond2 is not None and clip2 is not cond2.model:
        cond2 = copy.copy(cond2)
        cond2.model = clip2
    return dataclasses.replace(model, unet=unet, conditioner=cond, conditioner2=cond2)


def _file_id(path: str) -> tuple:
    return path, os.path.getmtime(path)
