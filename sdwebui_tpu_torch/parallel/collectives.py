"""Shard groups and their collectives: what XLA provides to the JAX package.

A :class:`Group` is one mesh axis's shards.  :meth:`Group.run` runs the
same per-shard function on every shard at once, each on a thread of its
own (rank 0 on the calling thread), as ``shard_map`` runs one program per
device: shards that meet at collectives must run at once (shards that
meet at none go through :meth:`Group.map`, one after another).  Each
shard runs with the caller's grad and inference mode, the CUDA device of
its shard, and the caller's axes plus its own (thread-local,
:func:`axes`).  Module-level switches (the attention impl, the forced
plain LayerNorm, the options, the dtype policy) are process-wide:
entered once by the driving thread, every shard sees them.

The collectives (:func:`psum`, :func:`all_gather`, :func:`ppermute`,
:func:`axis_size`, :func:`axis_index`) are called by every shard of the
axis with its own tensor.  They meet at a barrier; rank 0 computes every
shard's result in a fixed order (so shards that should agree agree to the
bit) and each shard takes its own, a tensor of its own: two shards on one
device never share a result, so a later in-place op on one does not write
into another.  A CUDA tensor crossing shards is ordered by events: the
sender records one on its current stream, the combining thread waits on
it, and the receiver waits on the one recorded after the combine.  A
failure on any shard breaks the barrier, every shard stops, and
:meth:`Group.run` raises the first real error: nothing carries on
unsharded.

The tensor-parallel UNet needs gradients through its collectives; they
are Megatron's pairs, each one ``torch.autograd.Function`` applied once to
every shard's tensor (one node of the graph with a tensor per shard, as
``nn.DataParallel``'s Broadcast and Gather):

- :func:`copy_to_model`: identity forward, psum backward;
- :func:`reduce_from_model`: psum forward, identity backward;
- :func:`gather_from_model`: all-gather forward, own slice backward;
- :func:`scatter_to_model`: own slice forward, all-gather backward.

One backward call over every shard's loss then runs the whole graph
(``training/train_step``); no barrier is ever waited on in a backward, so
PyTorch's one autograd thread per device cannot deadlock on a card named
several times.  Without grad the pairs are the plain collectives.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

_local = threading.local()


def axes() -> dict:
    """This thread's {axis name: (group, rank)}."""
    return getattr(_local, "axes", {})


def _axis(name: str):
    a = axes().get(name)
    if a is None:
        raise RuntimeError(f"no {name!r} axis here: collectives run inside Group.run")
    return a


def axis_size(name: str) -> int:
    return _axis(name)[0].size


def axis_index(name: str) -> int:
    return _axis(name)[1]


# --------------------------------------------------------------------------
# the spatial (row-sharded) context of the VAE: thread-local, as the axes
# --------------------------------------------------------------------------

def spatial_axis() -> str | None:
    """The axis the rows of this thread's image are sharded over, or None."""
    return getattr(_local, "spatial", None)


@contextlib.contextmanager
def spatial_sharding(axis_name: str):
    """Ops inside hold a row slice of the image: 3×3 convs exchange halo
    rows over `axis_name`, GroupNorm sums its statistics over it."""
    prev = spatial_axis()
    _local.spatial = axis_name
    try:
        yield
    finally:
        _local.spatial = prev


# --------------------------------------------------------------------------
# the group
# --------------------------------------------------------------------------

def _event(t: torch.Tensor):
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _wait(ev, device) -> None:
    if ev is not None:
        torch.cuda.current_stream(device).wait_event(ev)


class Group:
    """The shards of one mesh axis, one device each (a device may repeat)."""

    def __init__(self, name: str, devices):
        self.name = name
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        self._barrier = threading.Barrier(self.size)
        self._slots: list = [None] * self.size
        self._result = None
        self._pool: ThreadPoolExecutor | None = None
        self._running = threading.Lock()

    def run(self, fn) -> list:
        """[fn(0), ..., fn(n - 1)], each on its shard's thread at once."""
        state = (torch.is_grad_enabled(), torch.is_inference_mode_enabled(), dict(axes()))
        if self.size == 1:
            return [self._shard(fn, 0, state)]
        with self._running:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.size - 1,
                                                thread_name_prefix=f"shard-{self.name}")
            futures = [self._pool.submit(self._shard, fn, r, state)
                       for r in range(1, self.size)]
            results, errors = [None] * self.size, []
            try:
                results[0] = self._shard(fn, 0, state)
            except BaseException as e:    # noqa: BLE001 - re-raised below
                errors.append(e)
            for r, fut in enumerate(futures, 1):
                try:
                    results[r] = fut.result()
                except BaseException as e:    # noqa: BLE001 - re-raised below
                    errors.append(e)
            if errors:
                self._barrier.reset()
                self._slots = [None] * self.size
                real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
                raise (real or errors)[0]
            return results

    def map(self, fn) -> list:
        """[fn(0), ..., fn(n - 1)] for shards that run no collective, one
        after another on the calling thread, each under its shard's axes and
        device.  CUDA launches return before the work ends, so shards on
        distinct cards overlap on the devices all the same; on one H100
        named four times, a data=4 txt2img took 19.46–21.18 s with the
        shards on threads against 6.40–7.93 s in turn (the GIL handed over
        at every op; ``tools/phase_4q_cuda.py threads``).  Threads over
        distinct cards are not measured."""
        state = (torch.is_grad_enabled(), torch.is_inference_mode_enabled(), dict(axes()))
        return [self._shard(fn, r, state, in_run=False) for r in range(self.size)]

    def _shard(self, fn, rank: int, state, in_run: bool = True):
        grad, inference, outer = state
        prev = axes()
        _local.axes = {**outer, self.name: (self, rank)}
        dev = self.devices[rank]
        try:
            with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                    (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
                return fn(rank)
        except BaseException:
            if in_run:      # the other shards stop at their next barrier
                self._barrier.abort()
            raise
        finally:
            _local.axes = prev

    def exchange(self, rank: int, x, combine):
        """Every shard hands in `x` (a tensor or a tuple of them); rank 0
        calls combine(list of every shard's x) → a list with each shard's
        result, and each shard gets its own."""
        parts = x if isinstance(x, tuple) else (x,)
        self._slots[rank] = (x, [_event(t) for t in parts])
        self._barrier.wait()
        if rank == 0:
            try:
                slots, self._slots = self._slots, [None] * self.size
                for (value, events) in slots:
                    vals = value if isinstance(value, tuple) else (value,)
                    for t, ev in zip(vals, events):
                        _wait(ev, t.device)
                out = combine([value for value, _ in slots])
                self._result = [(o, [_event(t) for t in (o if isinstance(o, tuple) else (o,))])
                                for o in out]
            except BaseException:
                self._barrier.abort()
                raise
        self._barrier.wait()
        out, events = self._result[rank]
        for t, ev in zip(out if isinstance(out, tuple) else (out,), events):
            _wait(ev, t.device)
        return out


# --------------------------------------------------------------------------
# the combines: every shard's tensor in, every shard's own result out
# --------------------------------------------------------------------------

_LOW = (torch.bfloat16, torch.float16)


def _psum_list(xs, devices) -> list:
    """Σ in rank order (fp32 for bf16 / fp16), a copy on each shard's device."""
    acc = torch.float32 if xs[0].dtype in _LOW else xs[0].dtype
    total = xs[0].to(devices[0], acc, copy=True)
    for x in xs[1:]:
        total += x.to(devices[0], acc)
    total = total.to(xs[0].dtype)
    return [total] + [total.to(d, copy=True) for d in devices[1:]]


def _gather_list(xs, devices, dim: int) -> list:
    return [torch.cat([x.to(d) for x in xs], dim=dim) for d in devices]


def _slice(x, rank: int, size: int, dim: int):
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n)


# --------------------------------------------------------------------------
# the collectives (without gradients)
# --------------------------------------------------------------------------

def psum(x: torch.Tensor, name: str) -> torch.Tensor:
    g, r = _axis(name)
    return g.exchange(r, x, lambda xs: _psum_list(xs, g.devices))


def all_gather(x: torch.Tensor, name: str, dim: int = 0) -> torch.Tensor:
    """Every shard's x concatenated along `dim` (JAX's tiled all_gather)."""
    g, r = _axis(name)
    return g.exchange(r, x, lambda xs: _gather_list(xs, g.devices, dim))


def ppermute(x: torch.Tensor, name: str, perm) -> torch.Tensor:
    """Shard dst gets src's x for each (src, dst) of `perm`; a shard that
    is no destination gets zeros (``lax.ppermute``)."""
    g, r = _axis(name)

    def combine(xs):
        out = [torch.zeros_like(x) for x in xs]
        for src, dst in perm:
            out[dst] = xs[src].to(g.devices[dst], copy=True)
        return out

    return g.exchange(r, x, combine)


def halo_rows(x: torch.Tensor, name: str, pad: int):
    """(the `pad` rows above this shard's first, the `pad` rows below its
    last) of a row-sharded NCHW tensor, zeros at the image border: one
    exchange for both (``layers._halo_exchange_rows``'s two ppermutes)."""
    g, r = _axis(name)

    def combine(parts):
        out = []
        for i, dev in enumerate(g.devices):
            top, bottom = parts[i]
            above = parts[i - 1][1].to(dev, copy=True) if i > 0 else torch.zeros_like(bottom)
            below = parts[i + 1][0].to(dev, copy=True) if i + 1 < g.size \
                else torch.zeros_like(top)
            out.append((above, below))
        return out

    return g.exchange(r, (x[:, :, :pad], x[:, :, -pad:]), combine)


# --------------------------------------------------------------------------
# Megatron's pairs: one autograd node over every shard's tensor
# --------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *xs):
        ctx.devices = devices
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_psum_list(gs, ctx.devices))


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *xs):
        return tuple(_psum_list(xs, devices))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dim, *xs):
        ctx.dim = dim
        return tuple(_gather_list(xs, devices, dim))

    @staticmethod
    def backward(ctx, *gs):
        n = len(gs)
        return (None, None, *(_slice(g, r, n, ctx.dim).contiguous() for r, g in enumerate(gs)))


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dim, *xs):
        ctx.dim, ctx.devices = dim, devices
        n = len(xs)
        return tuple(_slice(x, r, n, dim).clone() for r, x in enumerate(xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_gather_list(gs, ctx.devices, ctx.dim))


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _node(fn, x, name: str, *args):
    g, r = _axis(name)
    return g.exchange(r, x, lambda xs: list(fn.apply(g.devices, *args, *xs)))


def copy_to_model(x: torch.Tensor, name: str = "model") -> torch.Tensor:
    """Where a replicated activation enters a model-parallel region."""
    if x is None or not _needs_grad(x):
        return x
    return _node(_CopyToModel, x, name)


def reduce_from_model(x: torch.Tensor, name: str = "model") -> torch.Tensor:
    """The sum of every model shard's partial product."""
    if not _needs_grad(x):
        return psum(x, name)
    return _node(_ReduceFromModel, x, name)


def gather_from_model(x: torch.Tensor, dim: int, name: str = "model") -> torch.Tensor:
    """Every model shard's slice, concatenated along `dim`."""
    if not _needs_grad(x):
        return all_gather(x, name, dim)
    return _node(_GatherFromModel, x, name, dim)


def scatter_to_model(x: torch.Tensor, dim: int, name: str = "model") -> torch.Tensor:
    """This model shard's slice of a replicated activation along `dim`."""
    g, r = _axis(name)
    if not _needs_grad(x):
        return _slice(x, r, g.size, dim)
    return _node(_ScatterToModel, x, name, dim)
