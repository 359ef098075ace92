"""Sharding rules: which dim of each UNet weight splits over ``model``, and
the tensor-parallel UNet they make.

Port of ``sdwebui_tpu/parallel/sharding.py``.  The rule table is JAX's
``_spec_for`` key for key, in torch's layouts: JAX's (I, O) linears and
HWIO convs are (O, I) and OIHW here, so

- column-parallel (``to_q/k/v``, ``ff.net.0.proj``, ``q/k/v_proj``,
  ``mlp.fc1``) splits dim 0, the output features;
- row-parallel (``to_out.0``, ``ff.net.2``, ``out_proj``, ``mlp.fc2``)
  splits dim 1, the reduced features;
- a conv splits dim 0, its output channels;
- a dim that does not divide the axis stays replicated, as does every
  other key (biases included: a column-parallel layer uses its slice).

Where JAX's GSPMD inserts the collectives, the modules do it themselves
(``models/unet``, ``models/layers``): a split conv computes its slice of
the output channels and all-gathers it; an attention runs its H/model
heads through the same ``attention`` dispatch (all of them, after a
gather of q, k and v, when H does not divide) and psums ``to_out.0``'s
partial products; the feed-forward psums ``ff.net.2``'s; each adds its
bias once, after the sum.  ``ff.net.0.proj`` is GEGLU's [h | gate]
projection: model shard r takes the r-th slice of BOTH halves, so its
``chunk(2)`` pairs h with its own gate (a contiguous split would give
shard 0 all of h and shard 1 all of gate).

:func:`shard_params` gives each model shard a UNet that stores only its part
of each split weight; :class:`TensorParallelUNet` runs them together.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from sdwebui_tpu_torch.parallel.collectives import Group
from sdwebui_tpu_torch.parallel.mesh import MODEL_AXIS, MeshRuntime, on_device

_COL_PARALLEL = ("to_q.weight", "to_k.weight", "to_v.weight",
                 "ff.net.0.proj.weight", "q_proj.weight", "k_proj.weight",
                 "v_proj.weight", "mlp.fc1.weight")
_ROW_PARALLEL = ("to_out.0.weight", "ff.net.2.weight", "out_proj.weight",
                 "mlp.fc2.weight")
_GEGLU = "ff.net.0.proj.weight"


def split_dim(path: str, shape, model_size: int) -> int | None:
    """The dim of the (torch-layout) weight `path` split over ``model``, or
    None when it is replicated (``sharding.py:29-42``)."""
    if model_size <= 1:
        return None
    ndim = len(shape)
    for suf in _COL_PARALLEL:
        if path.endswith(suf) and ndim == 2 and shape[0] % model_size == 0:
            return 0
    for suf in _ROW_PARALLEL:
        if path.endswith(suf) and ndim == 2 and shape[1] % model_size == 0:
            return 1
    if path.endswith(".weight") and ndim == 4 and shape[0] % model_size == 0:
        return 0
    return None


def param_shardings(rt: MeshRuntime, state_dict: dict) -> dict:
    """{key: split dim or None} for every entry of a state dict."""
    return {k: split_dim(k, tuple(v.shape), rt.model_size) for k, v in state_dict.items()}


def partial_grad_keys(dims: dict) -> list:
    """The replicated biases that a model shard uses sliced (a
    column-parallel layer's): each shard's gradient holds only its slice,
    so the train step sums them over ``model``."""
    return [k for k in dims if k.endswith(".bias") and dims.get(k[:-5] + ".weight") == 0]


def _part(path: str, t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    if path.endswith(_GEGLU):
        h, gate = t.chunk(2, dim=0)
        if h.shape[0] % size:
            raise NotImplementedError(f"{path}: GEGLU's {h.shape[0]} features do not divide "
                                      f"the model axis {size}")
        n = h.shape[0] // size
        return torch.cat([h[rank * n:(rank + 1) * n], gate[rank * n:(rank + 1) * n]])
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def _owner(path: str) -> str:
    return path.rsplit(".", 1)[0]


def shard_params(unet: nn.Module, devices, share: bool = True) -> list:
    """One UNet per model shard on `devices`, each storing its slice of
    every split weight (the others whole).  share: a shard on the source's
    device shares the replicated tensors with the source (generation);
    False gives every shard tensors of its own (training).  Only the
    UNet's modules run split (``models/unet``); an SD3 MMDiT raises."""
    from sdwebui_tpu_torch.models.unet import UNetModel

    if not isinstance(unet, UNetModel):
        raise NotImplementedError(
            f"tensor-parallel {type(unet).__name__} is not ported: only the UNet runs over a "
            "model axis > 1 (tensor-parallel SD3 (MMDiT) is left out)")
    size = len(devices)
    named = dict(unet.named_parameters())
    named.update(dict(unet.named_buffers()))
    dims = {k: split_dim(k, tuple(v.shape), size) for k, v in named.items()}
    shards = []
    for rank, dev in enumerate(devices):
        dev = torch.device(dev)
        memo = {}
        for k, t in named.items():
            if dims[k] is None:
                new = t if share and t.device == dev else t.detach().to(dev, copy=True)
            else:
                new = _part(k, t.detach(), dims[k], rank, size).to(dev, copy=True)
            if isinstance(t, nn.Parameter) and new is not t:
                new = nn.Parameter(new.contiguous(memory_format=_format(t)),
                                   requires_grad=t.requires_grad)
            memo[id(t)] = new
        shard = copy.deepcopy(unet, memo)
        modules = dict(shard.named_modules())
        for k, d in dims.items():
            if d is not None and k.endswith(".weight"):
                modules[_owner(k)].model_shard = (rank, size)
        shard.split_dims = dims
        shards.append(shard)
    return shards


def _format(t: torch.Tensor):
    return torch.channels_last if t.dim() == 4 and t.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format


def gather_state_dict(shards: list, state_dicts: list | None = None) -> dict:
    """The whole state dict of a UNet split by :func:`shard_params` (or of
    per-shard dicts keyed as its state dict, its gradients say)."""
    sds = state_dicts if state_dicts is not None else [s.state_dict() for s in shards]
    dims = shards[0].split_dims
    out = {}
    for k, v in sds[0].items():
        d = dims.get(k)
        if d is None:
            out[k] = v
        elif k.endswith(_GEGLU):
            halves = [sd[k].chunk(2, dim=0) for sd in sds]
            out[k] = torch.cat([h for h, _ in halves] + [g for _, g in halves])
        else:
            out[k] = torch.cat([sd[k].to(v.device) for sd in sds], dim=d)
    return out


def _to(t, device, copy_it: bool):
    if t is None:
        return None
    return t.to(device, copy=copy_it)


class TensorParallelUNet:
    """A UNet split over one model group: called as the UNet is, it runs
    every shard on its thread and returns model shard 0's output."""

    def __init__(self, shards: list, devices):
        self.shards = shards
        self.cfg = shards[0].cfg
        self.group = Group(MODEL_AXIS, devices)

    def __call__(self, x, timesteps, context, y=None, control=None, hypernet=None,
                 tiling: bool = False, attn=None):
        kw = {} if attn is None else {"attn": attn}

        def run(rank):
            dev, own = self.group.devices[rank], rank > 0
            ctrl = None
            if control is not None:
                ctrl = {"input": tuple(_to(t, dev, own) for t in control["input"]),
                        "middle": _to(control["middle"], dev, own)}
            return self.shards[rank](_to(x, dev, own), _to(timesteps, dev, own),
                                     _to(context, dev, own), _to(y, dev, own),
                                     control=ctrl, hypernet=on_device(hypernet, dev),
                                     tiling=tiling, **kw)

        return self.group.run(run)[0]
