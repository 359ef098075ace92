"""Server application state: the models, the queue lock and the job state.

Port of the txt2img and img2img parts of ``sdwebui_tpu/server/app.py:24-379``:
an ``Engine`` owns one base ``SDModel`` (random-weight SD1.5 or SDXL, or a
tiny test model) on an explicit device, plus resident extra models keyed
by checkpoint title (the SDXL refiner, ``app.py:343-361``), and runs
generations one at a time under its queue lock, keeping the job's
progress in a ``runtime.state.State``.  Checkpoint loading and VAE
switching come later.
"""

from __future__ import annotations

import threading

from sdwebui_tpu_torch.ops.attention import set_attention_impl
from sdwebui_tpu_torch.pipeline.img2img import process_img2img
from sdwebui_tpu_torch.pipeline.params import GenerationParams, Processed
from sdwebui_tpu_torch.pipeline.processing import process_txt2img, uses_refiner
from sdwebui_tpu_torch.pipeline.sd_model import (SDModel, create_random_sd15,
                                                 create_random_sdxl,
                                                 create_tiny_sd,
                                                 create_tiny_sdxl)
from sdwebui_tpu_torch.runtime.state import State
from sdwebui_tpu_torch.utils.devices import get_device
from sdwebui_tpu_torch.utils.options import opts

#: opts.cross_attention_optimization → attention impl
ATTENTION_IMPLS = {"Automatic": None, "flash": "flash", "flash-packed": "flash-packed",
                   "plain": "plain"}

#: seed offset of the random SDXL refiner (the JAX bench's 100 for base 0)
REFINER_SEED_OFFSET = 100


def random_models(family: str, device, tiny: bool = False, seed: int = 0):
    """(base, extra models by title) for the random-weight mode: SD1.5, or
    the SDXL base with its refiner, which shares the base's bigG and VAE
    (bench.py:474-477)."""
    if family == "sd15":
        return (create_tiny_sd if tiny else create_random_sd15)(seed, device), {}
    if family != "sdxl":
        raise ValueError(f"unknown model family {family!r} (sd15 or sdxl)")
    make = create_tiny_sdxl if tiny else create_random_sdxl
    base = make(seed, device)
    refiner = make(seed + REFINER_SEED_OFFSET, device, refiner=True, shared=base)
    return base, {refiner.title: refiner}


class Engine:
    def __init__(self, device="cuda", tiny: bool = False, seed: int = 0,
                 model: SDModel | None = None, family: str = "sd15",
                 extra_models: dict[str, SDModel] | None = None):
        self.device = get_device(device)
        made = {}
        if model is None:
            model, made = random_models(family, self.device, tiny, seed)
        self.sd_model = model
        self._extra_models = {**made, **(extra_models or {})}
        self.queue_lock = threading.Lock()
        self.state = State()

    def _resolve_refiner(self, p: GenerationParams) -> SDModel | None:
        """The resident model a request names as its refiner (app.py:343-361);
        the port has no checkpoint loader, so any other title raises."""
        if not uses_refiner(p):
            return None
        model = self._extra_models.get(p.refiner_checkpoint)
        if model is None:
            raise NotImplementedError(
                f"refiner checkpoint {p.refiner_checkpoint!r} is not resident "
                f"(resident: {sorted(self._extra_models)}); checkpoint loading "
                "is not ported yet")
        return model

    def _apply_runtime_opts(self):
        """Push live settings into every resident model's conditioners and
        the attention dispatch (app.py:73-94)."""
        for model in (self.sd_model, *self._extra_models.values()):
            for cond in (model.conditioner, model.conditioner2):
                if cond is not None:
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

    def _run(self, job: str, p: GenerationParams, fn) -> Processed:
        """One generation under the queue lock, with the job state set."""
        with self.queue_lock:
            with opts.override(p.override_settings):
                self._apply_runtime_opts()
            self.state.begin(job)
            self.state.job_count = p.n_iter
            try:
                return fn()
            finally:
                self.state.end()

    def txt2img(self, p: GenerationParams) -> Processed:
        return self._run("txt2img", p, lambda: process_txt2img(
            self.sd_model, p, step_callback=self._step_callback,
            refiner_model=self._resolve_refiner(p)))

    def img2img(self, p: GenerationParams) -> Processed:
        """app.py:363-379: img2img and inpainting on the base model."""
        return self._run("img2img", p, lambda: process_img2img(
            self.sd_model, p, step_callback=self._step_callback))
