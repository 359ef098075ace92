"""The device mesh: a (data, model) grid of torch devices.

Port of ``sdwebui_tpu/parallel/mesh.py``.  The ``data`` axis carries the
batch (and the latent rows of a row-sharded VAE), the ``model`` axis the
tensor-parallel UNet's heads and channels; model is innermost.  A mesh is
an explicit list of ``torch.device``s and a device may repeat, so one card
named n times runs every sharded path (each shard on a thread of its own,
``parallel/collectives``).  ``devices=None`` takes every visible CUDA card
and raises when there is none: a mesh never falls back to the CPU.

JAX's ``NamedSharding`` helpers become explicit split and copy helpers:
:meth:`MeshRuntime.shard_batch` splits dim 0 over ``data``,
:meth:`MeshRuntime.replicate` copies to each data shard's device.
:func:`on_device` is the replica cache: a module, hypernetwork or tensor
on another device, made once per (object, device) and dropped with the
object (a checkpoint swap, a LoRA or hypernetwork change) or by
:func:`set_runtime`.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import threading
import weakref
from typing import Sequence

import torch

from sdwebui_tpu_torch.parallel.collectives import Group

DATA_AXIS = "data"
MODEL_AXIS = "model"


def visible_cards() -> list:
    """Every CUDA card torch sees; none raises."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA card is visible: pass devices= to MeshRuntime.create "
                           "(a mesh does not fall back to the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass(frozen=True, eq=False)
class MeshRuntime:
    grid: tuple          # grid[d][m]: the device of data shard d, model shard m

    @staticmethod
    def create(data: int | None = None, model: int = 1,
               devices: Sequence | None = None) -> "MeshRuntime":
        """A (data, model) grid over `devices` (default: every visible card);
        data=None uses every device the model axis leaves."""
        devs = [torch.device(d) for d in devices] if devices is not None else visible_cards()
        n = len(devs)
        if model < 1 or n % model:
            raise ValueError(f"model axis {model} does not divide {n} devices")
        if data is None:
            data = n // model
        if data < 1 or data * model > n:
            raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices, "
                             f"{n} were given")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh takes devices of one type, got {devs}")
        devs = devs[: data * model]
        return MeshRuntime(tuple(tuple(devs[i * model:(i + 1) * model]) for i in range(data)))

    @property
    def data_size(self) -> int:
        return len(self.grid)

    @property
    def model_size(self) -> int:
        return len(self.grid[0])

    @property
    def n_devices(self) -> int:
        return self.data_size * self.model_size

    @property
    def devices(self) -> tuple:
        return tuple(d for row in self.grid for d in row)

    @property
    def data_devices(self) -> tuple:
        """The device of each data shard's model shard 0."""
        return tuple(row[0] for row in self.grid)

    @property
    def device_type(self) -> str:
        return self.grid[0][0].type

    def shard_batch(self, x: torch.Tensor) -> list:
        """x split along dim 0 into data_size copies, each on its shard's
        device (the batch must divide; the pipeline checks it)."""
        if x.shape[0] % self.data_size:
            raise ValueError(f"batch {x.shape[0]} does not divide the data axis "
                             f"{self.data_size}")
        return [part.to(dev, copy=True) for part, dev in
                zip(x.chunk(self.data_size, dim=0), self.data_devices)]

    def replicate(self, x: torch.Tensor) -> list:
        """A copy of x on each data shard's device."""
        return [x.to(dev, copy=True) for dev in self.data_devices]

    def pad_batch(self, n: int) -> int:
        """Smallest multiple of the data-axis size ≥ n (batch bucketing)."""
        d = self.data_size
        return int(math.ceil(n / d) * d)


_runtime: MeshRuntime | None = None
_set_explicitly = False


def get_runtime() -> MeshRuntime:
    """The process's runtime; the first call without one set makes the
    default over every visible card (raising when there is none)."""
    global _runtime
    if _runtime is None:
        _runtime = MeshRuntime.create()
    return _runtime


def set_runtime(rt: MeshRuntime | None) -> None:
    """Set the runtime (None: back to the default) and drop every replica."""
    global _runtime, _set_explicitly
    _runtime = rt
    _set_explicitly = rt is not None
    _replicas.clear()


def check_device_type(rt: MeshRuntime, device) -> None:
    device = torch.device(device)
    if rt.device_type != device.type:
        raise ValueError(f"the runtime's devices are {rt.device_type!r} but the model is on "
                         f"{device}: set a runtime over {device.type!r} devices")


def runtime_for(device, rt: MeshRuntime | None = None) -> MeshRuntime | None:
    """The runtime a model on `device` runs under, or None to run unsharded.

    `rt` (a replicated model's own) wins; then the one set with
    :func:`set_runtime`; a CUDA model then takes the default over every
    card, while a CPU model runs unsharded.  A runtime whose devices are
    not of the model's device type raises.  A one-device runtime is None."""
    device = torch.device(device)
    if rt is None:
        if _set_explicitly:
            rt = _runtime
        elif device.type == "cuda":
            rt = get_runtime()
        else:
            return None
    check_device_type(rt, device)
    return rt if rt.n_devices > 1 else None


# --------------------------------------------------------------------------
# the replica cache
# --------------------------------------------------------------------------

class _Replicas:
    """Per-object caches keyed by identity, each dropped when its object is
    collected (objects need not be hashable: a hypernetwork is a dataclass).
    Shard threads fill them too: one lock, re-entrant for nested makes."""

    def __init__(self):
        self._entries: dict = {}
        self.lock = threading.RLock()

    def get(self, obj) -> dict:
        key = id(obj)
        with self.lock:
            entry = self._entries.get(key)
            if entry is None or entry[0]() is not obj:
                entry = (weakref.ref(obj), {})
                self._entries[key] = entry
                weakref.finalize(obj, self._entries.pop, key, None)
            return entry[1]

    def drop(self, obj) -> None:
        with self.lock:
            entry = self._entries.get(id(obj))
            if entry is not None and entry[0]() is obj:
                del self._entries[id(obj)]

    def clear(self) -> None:
        with self.lock:
            self._entries.clear()


_replicas = _Replicas()


def _tree_to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _tree_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _tree_to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _device_of(obj):
    """The device of the first tensor in `obj` (a module, a tensor, or a
    dataclass / dict / list holding tensors), or None."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, torch.nn.Module):
        return next((t.device for t in itertools.chain(obj.parameters(), obj.buffers())), None)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for v in obj:
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


def on_device(obj, device):
    """`obj` on `device`: itself when it is there already (shards that name
    one device share it, read-only), else a copy made once and kept while
    `obj` lives.  Modules are deep-copied and moved; a dataclass of tensors
    (a hypernetwork) is mapped; a dict or list is mapped uncached."""
    if obj is None:
        return None
    device = torch.device(device)
    if _device_of(obj) in (None, device):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (dict, list, tuple)):      # not weakly referable: copied each time
        return _tree_to(obj, device)
    with _replicas.lock:
        per = _replicas.get(obj)
        if device not in per:
            if isinstance(obj, torch.nn.Module):
                per[device] = copy.deepcopy(obj).to(device)
            else:
                per[device] = _tree_to(obj, device)
        return per[device]


def drop_replicas(*objs) -> None:
    """Forget the copies and shards made from `objs` (a module changed in
    place: fp8 storage, a move to another device)."""
    for obj in objs:
        if obj is not None:
            _replicas.drop(obj)


def cached(obj, name, make):
    """A derived object (a model's shard set, say) cached on `obj` under
    `name` while `obj` lives, until :func:`set_runtime`."""
    with _replicas.lock:
        per = _replicas.get(obj)
        if name not in per:
            per[name] = make()
        return per[name]


def data_group(rt: MeshRuntime):
    """The runtime's ``data``-axis shard group (one per runtime)."""
    return cached(rt, "data_group", lambda: Group(DATA_AXIS, rt.data_devices))


def model_group(rt: MeshRuntime, d: int):
    """Data shard d's ``model``-axis shard group."""
    return cached(rt, ("model_group", d), lambda: Group(MODEL_AXIS, rt.grid[d]))
