"""chip_smoke's 4q (e) alone, on the package under ROOT: one (data=2,
model=2) train step at SD1.5 widths against the one-device step.

    python3 tools/train_step_check_cuda.py [ROOT]

ROOT (default: this checkout) holds the ``sdwebui_tpu_torch`` to check, so
a copy with one line changed can be passed as a planted fault; chip_smoke
comes from this checkout.  Exits 0 when 4q (e)'s bounds hold, 1 when they
do not (what a planted fault must give), and logs 4q (e)'s readings.
Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, root)
    sys.path.append(HERE)
    import chip_smoke as c
    import sdwebui_tpu_torch
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.log(f"package {os.path.dirname(sdwebui_tpu_torch.__file__)}")
    model = create_random_sd15(seed=0, device=torch.device("cuda"))
    info = {}
    try:
        c._train(model, torch.device("cuda", torch.cuda.current_device()), info)
    except AssertionError as e:
        c.log(f"4q (e) failed: {e}; {info.get('train_rel')}")
        return 1
    c.log(f"4q (e) held: {info.get('train_rel')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
