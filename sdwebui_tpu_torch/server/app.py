"""Server application state: one model, the queue lock and the job state.

Port of the txt2img part of ``sdwebui_tpu/server/app.py:24-343``: an
``Engine`` owns one ``SDModel`` (random-weight SD1.5, or the tiny test
model) on an explicit device and runs generations one at a time under its
queue lock, keeping the job's progress in a ``runtime.state.State``.
Checkpoint loading, VAE switching and the refiner come later.
"""

from __future__ import annotations

import threading
import time

from sdwebui_tpu.pipeline.params import GenerationParams, Processed
from sdwebui_tpu.runtime.state import State
from sdwebui_tpu.utils.options import opts
from sdwebui_tpu_torch.ops.attention import set_attention_impl
from sdwebui_tpu_torch.pipeline.processing import process_txt2img
from sdwebui_tpu_torch.pipeline.sd_model import (SDModel, create_random_sd15,
                                                 create_tiny_sd)
from sdwebui_tpu_torch.utils.devices import get_device

#: opts.cross_attention_optimization → attention impl
ATTENTION_IMPLS = {"Automatic": None, "flash": "flash", "plain": "plain"}


class Engine:
    def __init__(self, device="cuda", tiny: bool = False, seed: int = 0,
                 model: SDModel | None = None):
        self.device = get_device(device)
        if model is None:
            model = (create_tiny_sd(seed, self.device) if tiny
                     else create_random_sd15(seed, self.device))
        self.sd_model = model
        self.queue_lock = threading.Lock()
        self.state = State()

    def _apply_runtime_opts(self):
        """Push live settings into the conditioner and the attention
        dispatch (app.py:73-94)."""
        cond = self.sd_model.conditioner
        cond.emphasis = (opts.get("emphasis", "Original")
                         if opts.get("enable_emphasis", True) else "None")
        cond.comma_padding_backtrack = opts.get("comma_padding_backtrack", 20)
        impl = opts.get("cross_attention_optimization", "Automatic")
        if impl not in ATTENTION_IMPLS:
            raise NotImplementedError(
                f"cross_attention_optimization {impl!r} is not ported "
                f"(one of {sorted(ATTENTION_IMPLS)})")
        set_attention_impl(ATTENTION_IMPLS[impl])

    def _step_callback(self, i: int, n: int, latents) -> bool:
        self.state.sampling_step = i + 1
        self.state.sampling_steps = n
        return not (self.state.interrupted or self.state.skipped)

    def txt2img(self, p: GenerationParams) -> Processed:
        with self.queue_lock:
            with opts.override(p.override_settings):
                self._apply_runtime_opts()
            # State.begin/end also drive the JAX memory monitor, so the job
            # fields are set here directly
            s = self.state
            s.job, s.job_no, s.job_count = "txt2img", 0, p.n_iter
            s.sampling_step = s.sampling_steps = 0
            s.interrupted = s.skipped = s.stopping_generation = False
            s.time_start = time.time()
            try:
                return process_txt2img(self.sd_model, p,
                                       step_callback=self._step_callback)
            finally:
                s.job, s.job_count = "", 0
