"""Hypernetworks: per-width MLP pairs applied to the attention k/v context.

Port of ``sdwebui_tpu/networks/hypernetwork.py``: inference, creation
(``create_hypernetwork``: numpy draws, so a new network equals JAX's) and
saving, and the training forward's dropout.  A file holds,
per context width (768, 1024, 320, 640, 1280, ...), a (k, v) pair of small
MLPs; in every attention whose context has that width the keys see
``ctx + mult·MLP_k(ctx)`` and the values ``ctx + mult·MLP_v(ctx)``
(``models/unet.CrossAttention``), computed in fp32.  Files: the JAX
package's ``.safetensors`` layout (``{width}.{k|v}.linear.{i}.{weight,
bias, ln_weight, ln_bias}``, weights (in, out), ``activation_func`` in the
metadata) and the reference's ``.pt`` (``{width: [k_state_dict,
v_state_dict]}`` of ``torch.nn.Sequential`` Linear / activation /
LayerNorm stacks, ``activation_func``, ``activate_output``).  JAX draws
its dropout masks from a threefry key; the port draws them from a
``torch.Generator``, so the masks differ and only their rates match.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from sdwebui_tpu_torch.loader.safetensors_io import SafetensorsFile, write_safetensors
from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_object
from sdwebui_tpu_torch.networks import NetworkNotFound
from sdwebui_tpu_torch.utils.options import opts

#: where hypernetwork files live unless the caller says otherwise
DEFAULT_HYPERNETWORK_DIR = os.path.join("models", "hypernetworks")

ACTIVATIONS = {
    "linear": lambda x: x, "relu": F.relu, "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu, "swish": F.silu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
}


def parse_dropout_structure(layer_structure, use_dropout: bool,
                            last_layer_dropout: bool) -> list:
    """Per-position dropout probabilities from the create options
    (hypernetwork.py:28-43): the input and the output never drop, the
    hidden layers drop at 0.3, the last hidden one only with
    last_layer_dropout.  (1, 2, 2, 1) → [0, 0.3, 0.3, 0] or [0, 0.3, 0, 0]."""
    layer_structure = list(layer_structure or (1, 2, 1))
    if not use_dropout:
        return [0.0] * len(layer_structure)
    probs = [0.0] + [0.3] * (len(layer_structure) - 3)
    probs.append(0.3 if last_layer_dropout else 0.0)
    probs.append(0.0)
    return probs


def apply_module(layers: list, x, activation: str = "linear", multiplier: float = 1.0,
                 activate_output: bool = False, dropout=None):
    """ctx + multiplier·MLP(ctx) in fp32, returned in x's dtype; each layer a
    dict of fp32 tensors: weight (in, out), bias, and ln_weight / ln_bias
    for a LayerNorm after the activation.  dropout: (probabilities by
    position, torch.Generator) in training only: inverted dropout after
    layer i at probability[i + 1] (hypernetwork.py:46-76)."""
    act = ACTIVATIONS[activation]
    h = x.float()
    for i, layer in enumerate(layers):
        h = h @ layer["weight"]
        if "bias" in layer:
            h = h + layer["bias"]
        if i < len(layers) - 1 or activate_output:
            h = act(h)
        if "ln_weight" in layer:
            mean = h.mean(dim=-1, keepdim=True)
            var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
            h = (h - mean) / torch.sqrt(var + 1e-5) * layer["ln_weight"] + layer["ln_bias"]
        if dropout is not None and i + 1 < len(dropout[0]) and dropout[0][i + 1] > 0:
            p = float(dropout[0][i + 1])
            keep = torch.rand(h.shape, generator=dropout[1], device=h.device) < 1.0 - p
            h = torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
    return (x.float() + h * multiplier).to(x.dtype)


@dataclasses.dataclass
class Hypernetwork:
    layers: dict                    # {context width: (k layers, v layers)}
    activation: str = "linear"
    multiplier: float = 1.0
    activate_output: bool = False
    #: training only: (dropout probabilities by position, torch.Generator)
    dropout: tuple | None = None

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise NotImplementedError(f"hypernetwork activation {self.activation!r} is not "
                                      f"ported (one of {sorted(ACTIVATIONS)})")

    def with_multiplier(self, multiplier: float) -> "Hypernetwork":
        return dataclasses.replace(self, multiplier=multiplier)

    def context_pair(self, context):
        """(keys' context, values' context), or None when the file holds no
        MLPs for this context's width."""
        pair = self.layers.get(int(context.shape[-1]))
        if pair is None:
            return None
        return tuple(apply_module(mods, context, self.activation, self.multiplier,
                                  self.activate_output, self.dropout) for mods in pair)


def _init_weight(rng: np.random.Generator, cin: int, cout: int, weight_init: str) -> np.ndarray:
    """One (in, out) weight of a new network (hypernetwork.py:79-96)."""
    if weight_init in ("Normal", "Default"):
        w = rng.standard_normal((cin, cout)) * 0.01
    elif weight_init == "KaimingUniform":
        bound = np.sqrt(6.0 / cin)
        w = rng.uniform(-bound, bound, (cin, cout))
    elif weight_init == "KaimingNormal":
        w = rng.standard_normal((cin, cout)) * np.sqrt(2.0 / cin)
    elif weight_init == "XavierUniform":
        bound = np.sqrt(6.0 / (cin + cout))
        w = rng.uniform(-bound, bound, (cin, cout))
    elif weight_init == "XavierNormal":
        w = rng.standard_normal((cin, cout)) * np.sqrt(2.0 / (cin + cout))
    else:
        raise ValueError(f"unknown weight init {weight_init!r}")
    return w.astype(np.float32)


def init_module(dim: int, layer_structure=(1, 2, 1), seed: int = 0, weight_init: str = "Normal",
                add_layer_norm: bool = False) -> list:
    """One new MLP as layer dicts of numpy arrays (hypernetwork.py:99-116)."""
    rng = np.random.default_rng(seed)
    dims = [int(dim * m) for m in layer_structure]
    layers = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        layer = {"weight": _init_weight(rng, cin, cout, weight_init),
                 "bias": np.zeros((cout,), np.float32)}
        if add_layer_norm:
            layer["ln_weight"] = np.ones((cout,), np.float32)
            layer["ln_bias"] = np.zeros((cout,), np.float32)
        layers.append(layer)
    return layers


def create_hypernetwork(dims=(768, 320, 640, 1280), layer_structure=(1, 2, 1), seed: int = 0,
                        weight_init: str = "Normal", add_layer_norm: bool = False,
                        activation: str = "linear", device="cpu") -> Hypernetwork:
    """A new network: for each width the k and v MLPs from seeds
    seed + 2i and seed + 2i + 1 (hypernetwork.py:119-133), fp32 on `device`."""
    layers = {}
    for i, d in enumerate(dims):
        layers[int(d)] = tuple(
            [{k: torch.from_numpy(v).to(device) for k, v in layer.items()}
             for layer in init_module(d, layer_structure, seed + 2 * i + j, weight_init,
                                      add_layer_norm)]
            for j in (0, 1))
    return Hypernetwork(layers, activation)


def save_hypernetwork(hn: Hypernetwork, path: str, name: str = "", step: int = 0,
                      layer_structure=(1, 2, 1), dropout_structure=None) -> None:
    """The JAX package's ``.safetensors`` layout (hypernetwork.py:136-160):
    ``{width}.{k|v}.linear.{i}.{kind}``, the name, step, layer structure,
    activation and, from training, the dropout structure as metadata."""
    tensors = {}
    for dim, pair in hn.layers.items():
        for tag, mod in zip("kv", pair):
            for li, layer in enumerate(mod):
                for kind in ("weight", "bias", "ln_weight", "ln_bias"):
                    if kind in layer:
                        tensors[f"{dim}.{tag}.linear.{li}.{kind}"] = layer[kind].detach()
    meta = {"name": name, "step": str(step),
            "layer_structure": ",".join(str(x) for x in layer_structure),
            "activation_func": hn.activation}
    if dropout_structure is not None:
        meta["dropout_structure"] = ",".join(str(x) for x in dropout_structure)
    write_safetensors(path, tensors, metadata=meta)


def _layers_of_sequential(state_dict: dict) -> list:
    """A reference HypernetworkModule's ``linear.N.*`` state dict → layer
    dicts: each Linear (2-D weight, stored (out, in)) starts a layer, a
    LayerNorm after it (1-D weight) joins it."""
    by_index: dict = {}
    for key, t in state_dict.items():
        _, idx, kind = key.rsplit(".", 2)
        by_index.setdefault(int(idx), {})[kind] = t
    layers = []
    for idx in sorted(by_index):
        mod = by_index[idx]
        if mod["weight"].dim() == 2:
            layers.append({"weight": mod["weight"].float().t().contiguous(),
                           "bias": mod["bias"].float()})
        else:
            layers[-1].update(ln_weight=mod["weight"].float(), ln_bias=mod["bias"].float())
    return layers


def load_hypernetwork(path: str, device) -> Hypernetwork:
    """A ``.safetensors`` (the JAX package's layout) or reference ``.pt``
    hypernetwork, its tensors fp32 on `device`."""
    if path.endswith(".safetensors"):
        f = SafetensorsFile(path)
        layers: dict = {}
        for key in f.keys():
            dim, tag, _, li, kind = key.split(".")
            pair = layers.setdefault(int(dim), ([], []))
            mod = pair[0] if tag == "k" else pair[1]
            while len(mod) <= int(li):
                mod.append({})
            mod[int(li)][kind] = f.tensor(key).to(device, torch.float32)
        hn = Hypernetwork(layers, f.metadata.get("activation_func", "linear"))
    else:
        obj = load_torch_object(path)
        layers = {}
        for key, value in obj.items():
            if isinstance(key, int) or (isinstance(key, str) and key.isdigit()):
                k_sd, v_sd = value
                layers[int(key)] = tuple(
                    [{n: t.to(device) for n, t in layer.items()}
                     for layer in _layers_of_sequential(sd)] for sd in (k_sd, v_sd))
        hn = Hypernetwork(layers, obj.get("activation_func") or "linear",
                          activate_output=bool(obj.get("activate_output", False)))
    if opts.get("print_hypernet_extra", False):
        dims = ", ".join(str(d) for d in sorted(hn.layers))
        print(f"Hypernetwork {os.path.basename(path)}: dims=[{dims}] "
              f"activation={hn.activation}", flush=True)
    return hn


class HypernetworkRegistry:
    """The ``.pt`` / ``.safetensors`` files under `dirs`, by file stem; the
    last one loaded stays resident on its device."""

    def __init__(self, dirs=(DEFAULT_HYPERNETWORK_DIR,)):
        self.dirs = list(dirs)
        self.files: dict[str, str] = {}
        self._loaded: tuple | None = None
        self.refresh()

    def refresh(self):
        self.files = {}
        self._loaded = None
        for d in self.dirs:
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if fn.lower().endswith((".pt", ".safetensors")):
                    self.files[os.path.splitext(fn)[0]] = os.path.join(d, fn)

    def load(self, name: str, device) -> Hypernetwork:
        path = self.files.get(name)
        if path is None:
            raise NetworkNotFound(f"hypernetwork {name!r} not found in {self.dirs}")
        key = (path, os.path.getmtime(path), str(device))
        if self._loaded is None or self._loaded[0] != key:
            self._loaded = (key, load_hypernetwork(path, device))
        return self._loaded[1]


_registry: HypernetworkRegistry | None = None


def hypernet_registry() -> HypernetworkRegistry:
    global _registry
    if _registry is None:
        _registry = HypernetworkRegistry()
    return _registry


def set_hypernetwork_dirs(dirs) -> HypernetworkRegistry:
    """Point the process's hypernetwork registry at `dirs` (scanned now)."""
    global _registry
    _registry = HypernetworkRegistry(dirs)
    return _registry
