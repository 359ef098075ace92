"""Where a ``restore_faces`` txt2img request's extra time goes on one card.

    python3 tools/faces_probe_cuda.py

With a random SD1.5 (published widths) and seeded face nets at the
published widths (chip_smoke's ``write_face_files``, in a temporary
directory):
- config 1 (512², Euler a, 20 steps) in process, with and without
  ``restore_faces`` (CodeFormer at weight 0.5), medians of three wall
  times each, one after the other;
- ``faces.restore_faces`` on the request's image alone: its wall, the
  CodeFormer forward's device ms (CUDA events) and its device events;
- the host functions of one ``restore_faces`` by cumulative time
  (cProfile; it inflates Python-heavy code, so read the ranks, not the ms).
Needs a CUDA card.
"""

from __future__ import annotations

import cProfile
import os
import pstats
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("faces_probe_cuda: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.postprocessing import faces
    from sdwebui_tpu_torch.server.app import Engine

    device = torch.device("cuda")
    engine = Engine(model=create_random_sd15(0, device), device=device)
    base = dict(prompt="a photograph of an astronaut riding a horse", width=512, height=512,
                sampler_name="Euler a", steps=20, cfg_scale=7.5, seed=1234)
    restore = {"face_restoration_model": "CodeFormer", "code_former_weight": 0.5}
    with tempfile.TemporaryDirectory(prefix="faces_probe_") as d:
        paths = chip_smoke.write_face_files(d, device)
        faces.set_model_dirs("CodeFormer", [os.path.dirname(paths["CodeFormer"])])
        times = {False: [], True: []}
        for _ in range(4):                 # the first round warms up and loads the net
            for on in (False, True):
                p = GenerationParams(**base, restore_faces=on,
                                     override_settings=restore if on else {})
                times[on].append(wall(lambda: engine.txt2img(p)))
        plain, with_faces = (statistics.median(times[k][1:]) for k in (False, True))
        print(f"config 1 in process: {plain:.3f} s, with restore_faces {with_faces:.3f} s "
              f"(+{(with_faces - plain) * 1e3:.1f} ms); rounds {times}", flush=True)

        image = engine.txt2img(GenerationParams(**base)).images[0]
        net, _ = faces._load_restorer("CodeFormer", device)
        x = torch.rand((1, 3, 512, 512), device=device) * 2 - 1
        with torch.inference_mode():
            fwd = chip_smoke.cuda_ms(lambda: net(x, w=0.5), hide_host=False)
            events = chip_smoke.device_events(lambda: net(x, w=0.5))
        alone = statistics.median(
            wall(lambda: faces.restore_faces(image, "CodeFormer", device=device))
            for _ in range(3))
        print(f"faces.restore_faces on a 512² image: {alone * 1e3:.1f} ms wall; the CodeFormer "
              f"forward {fwd:.2f} ms of device time, {events} device events", flush=True)
        prof = cProfile.Profile()
        prof.enable()
        faces.restore_faces(image, "CodeFormer", device=device)
        torch.cuda.synchronize()
        prof.disable()
        pstats.Stats(prof).sort_stats("cumulative").print_stats(14)
        faces.set_model_dirs("CodeFormer", faces.DEFAULT_DIRS["CodeFormer"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
