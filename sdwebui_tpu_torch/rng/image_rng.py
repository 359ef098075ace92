"""Seeded per-image latent noise — reference-compatible semantics.

Copy of ``sdwebui_tpu/rng/image_rng.py``; the device sources ("TPU",
"GPU", "JAX") are ``rng/device_philox``'s torch port of its device Philox.

Replicates the observable behaviour of `modules/rng.py` (ImageRNG: per-seed
generators, subseed slerp, seed-resize overlay, eta-noise-seed-delta) in the
"NV" randn-source mode, on top of our counter-based Philox
(:mod:`sdwebui_tpu_torch.rng.philox`).  Noise is generated host-side in the
reference's CHW lane order (bit-exactness), optionally transposed to the
TPU-native NHWC layout, and can be pre-generated for a whole sampling run
in one call (``next_k``) so the device loop never waits on the host.
"""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.rng.philox import PhiloxGenerator


def slerp(val: float, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Spherical interp between noise tensors (reference modules/rng.py:85).

    Matches the reference quirk of normalizing along axis 1 of the (C,H,W)
    tensor and falling back to lerp when nearly colinear.
    """
    low = low.astype(np.float32)
    high = high.astype(np.float32)
    low_norm = low / np.linalg.norm(low, axis=1, keepdims=True)
    high_norm = high / np.linalg.norm(high, axis=1, keepdims=True)
    dot = (low_norm * high_norm).sum(1)

    if dot.mean() > 0.9995:
        return low * val + high * (1 - val)

    omega = np.arccos(np.clip(dot, -1.0, 1.0))
    so = np.sin(omega)
    res = (np.sin((1.0 - val) * omega) / so)[:, None] * low \
        + (np.sin(val * omega) / so)[:, None] * high
    return res.astype(np.float32)


class TorchCPUGenerator:
    """randn_source="CPU" stream (reference modules/rng.py create_generator
    with a cpu torch.Generator): same bits as the reference's CPU source,
    so seeds reproduce across vendors exactly as upstream promises."""

    def __init__(self, seed: int):
        import torch

        self.g = torch.Generator("cpu").manual_seed(int(seed) & ((1 << 63) - 1))
        self._torch = torch

    def randn(self, shape) -> np.ndarray:
        return self._torch.randn(tuple(shape), generator=self.g,
                                 device="cpu").numpy()

    def randn_batch(self, count: int, shape) -> np.ndarray:
        return np.stack([self.randn(shape) for _ in range(count)])


class ImageRNG:
    """Per-image seeded noise streams for one batch.

    shape: (C, H, W) latent shape per image (reference layout).
    channels_last: transpose outputs to (B, H, W, C) for TPU convs.
    gen_cls: per-seed generator backend — PhiloxGenerator ("NV", default)
    or TorchCPUGenerator ("CPU").
    """

    def __init__(self, shape, seeds, subseeds=None, subseed_strength=0.0,
                 seed_resize_from_h=0, seed_resize_from_w=0,
                 eta_noise_seed_delta=0, channels_last=True,
                 gen_cls=PhiloxGenerator):
        self.shape = tuple(int(x) for x in shape)
        self.seeds = [int(s) for s in seeds]
        self.subseeds = [int(s) for s in subseeds] if subseeds is not None else None
        self.subseed_strength = float(subseed_strength)
        self.seed_resize_from_h = int(seed_resize_from_h)
        self.seed_resize_from_w = int(seed_resize_from_w)
        self.eta_noise_seed_delta = int(eta_noise_seed_delta or 0)
        self.channels_last = channels_last

        self._gen_cls = gen_cls
        self.generators = [gen_cls(s) for s in self.seeds]
        self.is_first = True

    # ------------------------------------------------------------------

    def _layout(self, x: np.ndarray) -> np.ndarray:
        """(B,C,H,W) → requested layout."""
        if self.channels_last:
            return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))
        return x

    def _first(self) -> np.ndarray:
        c, h, w = self.shape
        if self.seed_resize_from_h > 0 and self.seed_resize_from_w > 0:
            noise_shape = (c, self.seed_resize_from_h // 8, self.seed_resize_from_w // 8)
        else:
            noise_shape = self.shape

        xs = []
        for i, (seed, gen) in enumerate(zip(self.seeds, self.generators)):
            subnoise = None
            if self.subseeds is not None and self.subseed_strength != 0:
                subseed = 0 if i >= len(self.subseeds) else self.subseeds[i]
                subnoise = self._gen_cls(subseed).randn(noise_shape)

            if noise_shape != self.shape:
                noise = self._gen_cls(seed).randn(noise_shape)
            else:
                noise = gen.randn(self.shape)

            if subnoise is not None:
                noise = slerp(self.subseed_strength, noise, subnoise)

            if noise_shape != self.shape:
                # seed-resize: overlay the resize-shaped noise centered onto a
                # full-shape draw from the per-image generator
                x = gen.randn(self.shape)
                dx = (self.shape[2] - noise_shape[2]) // 2
                dy = (self.shape[1] - noise_shape[1]) // 2
                ww = noise_shape[2] if dx >= 0 else noise_shape[2] + 2 * dx
                hh = noise_shape[1] if dy >= 0 else noise_shape[1] + 2 * dy
                tx = max(dx, 0)
                ty = max(dy, 0)
                dx = max(-dx, 0)
                dy = max(-dy, 0)
                x[:, ty:ty + hh, tx:tx + ww] = noise[:, dy:dy + hh, dx:dx + ww]
                noise = x

            xs.append(noise)

        if self.eta_noise_seed_delta:
            self.generators = [self._gen_cls(s + self.eta_noise_seed_delta)
                               for s in self.seeds]

        return np.stack(xs).astype(np.float32)

    # ------------------------------------------------------------------

    def first(self) -> np.ndarray:
        """NOTE reference quirk (modules/rng.py ImageRNG): first() does NOT
        consume the is_first flag — only next() does.  So the first next()
        call after first() REPLAYS the first-draw logic (subseed slerp /
        seed-resize overlay) on the generators' advanced streams; the
        reference's samplers rely on this for their first ancestral noise."""
        return self._layout(self._first())

    def next(self) -> np.ndarray:
        if self.is_first:
            self.is_first = False
            return self.first()
        xs = np.stack([g.randn(self.shape) for g in self.generators])
        return self._layout(xs.astype(np.float32))

    def next_k(self, k: int) -> np.ndarray:
        """Pre-generate the next k draws for every image: (k, B, ...).

        Same stream as k successive :meth:`next` calls, but one vectorized
        Philox pass — used to bake a whole run's ancestral/SDE noise into a
        single device upload consumed by the `lax.scan` sampling loop.
        """
        if k == 0:
            b = len(self.seeds)
            c, h, w = self.shape
            shp = (0, b, h, w, c) if self.channels_last else (0, b, c, h, w)
            return np.zeros(shp, dtype=np.float32)
        if self.is_first:
            # mirror next(): the first draw replays the first-draw logic
            head = self.next()[None]
            if k == 1:
                return head
            return np.concatenate([head, self.next_k(k - 1)], axis=0)
        per_img = [g.randn_batch(k, self.shape) for g in self.generators]  # each (k,C,H,W)
        out = np.stack(per_img, axis=1)  # (k,B,C,H,W)
        if self.channels_last:
            out = np.ascontiguousarray(np.transpose(out, (0, 1, 3, 4, 2)))
        return out.astype(np.float32)


def create_rng(shape, seeds, subseeds=None, subseed_strength=0.0,
               seed_resize_from_h=0, seed_resize_from_w=0,
               eta_noise_seed_delta=0, channels_last=True, device="cpu"):
    """randn_source dispatch (reference modules/rng.py:6-19 source switch).

    "NV" (default): host Philox, bit-exact with NVIDIA-GPU reference runs.
    "CPU": host torch CPU generator, bit-exact with reference CPU runs.
    "TPU" (aliases "GPU"/"JAX"): the same Philox counters generated on
    `device` (``rng/device_philox``), NCHW tensors.  Seed-resize falls back
    to the host path (uses numpy slicing).
    """
    from sdwebui_tpu_torch.utils.options import opts

    source = str(opts.get("randn_source", "NV"))
    if source in ("TPU", "GPU", "JAX") and not (
            seed_resize_from_h > 0 and seed_resize_from_w > 0):
        if channels_last:
            raise ValueError("the device noise source draws NCHW only")
        from sdwebui_tpu_torch.rng.device_philox import DevicePhiloxRNG

        return DevicePhiloxRNG(shape, seeds, device, subseeds=subseeds,
                               subseed_strength=subseed_strength,
                               eta_noise_seed_delta=eta_noise_seed_delta)
    gen_cls = TorchCPUGenerator if source == "CPU" else PhiloxGenerator
    return ImageRNG(shape, seeds, subseeds=subseeds,
                    subseed_strength=subseed_strength,
                    seed_resize_from_h=seed_resize_from_h,
                    seed_resize_from_w=seed_resize_from_w,
                    eta_noise_seed_delta=eta_noise_seed_delta,
                    channels_last=channels_last, gen_cls=gen_cls)
