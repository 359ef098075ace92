"""Run the API server.

    python -m sdwebui_tpu_torch.server [--ckpt-dir DIR] [--ckpt FILE_OR_NAME] [--vae-path FILE]
    python -m sdwebui_tpu_torch.server --model sd15|sdxl [--tiny] [--seed N]

Serves the checkpoint files (``.safetensors``, ``.ckpt``, ``.pt``) under
``--ckpt-dir`` (default ``models/Stable-diffusion``) and ``--ckpt``'s own
directory, loading ``--ckpt`` (a path or a file name there) first, else
the ``sd_model_checkpoint`` setting, else the first file found.
``--vae-path`` gives every checkpoint that VAE.  The ESRGAN / Real-ESRGAN
files (``.pth``, ``.pt``, ``.safetensors``) under ``--esrgan-models-path``
and ``--realesrgan-models-path`` (default ``models/ESRGAN`` and
``models/RealESRGAN``) serve as upscalers by file name.  Random weights at full
width, made from ``--seed``, only with ``--model``: SD1.5, or the SDXL
base with its refiner, which requests name by its title
(``refiner_checkpoint``); ``--tiny`` for the test models.
"""

from __future__ import annotations

import argparse
import os

from sdwebui_tpu_torch.models.esrgan import register_esrgan_dir
from sdwebui_tpu_torch.server.api import make_server
from sdwebui_tpu_torch.server.app import DEFAULT_CKPT_DIR, Engine

#: the upscaler files' directories (the reference's layout, relative to the
#: working directory)
DEFAULT_ESRGAN_DIRS = (os.path.join("models", "ESRGAN"), os.path.join("models", "RealESRGAN"))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sdwebui_tpu_torch.server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default="cuda", help="cuda or cpu (cuda never falls back)")
    ap.add_argument("--ckpt", default=None,
                    help="path to checkpoint of stable diffusion model; loaded first")
    ap.add_argument("--ckpt-dir", default=None,
                    help="Path to directory with stable diffusion checkpoints")
    ap.add_argument("--vae-path", default=None,
                    help="Checkpoint to use as VAE; setting this argument disables all "
                         "settings related to VAE")
    ap.add_argument("--model", choices=("sd15", "sdxl"), default=None,
                    help="serve random weights of this family instead of a checkpoint "
                         "(sdxl: base + refiner)")
    ap.add_argument("--esrgan-models-path", default=DEFAULT_ESRGAN_DIRS[0],
                    help="Path to directory with ESRGAN model file(s).")
    ap.add_argument("--realesrgan-models-path", default=DEFAULT_ESRGAN_DIRS[1],
                    help="Path to directory with RealESRGAN model file(s).")
    ap.add_argument("--tiny", action="store_true", help="with --model: the tiny test model(s)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)
    if args.model and (args.ckpt or args.ckpt_dir or args.vae_path):
        ap.error("--model serves random weights: it takes no --ckpt, --ckpt-dir or --vae-path")
    if args.tiny and not args.model:
        ap.error("--tiny needs --model")
    if args.vae_path and not os.path.isfile(args.vae_path):
        ap.error(f"--vae-path {args.vae_path!r} is not a file")
    if args.model:
        engine = Engine(device=args.device, tiny=args.tiny, seed=args.seed, family=args.model)
    else:
        engine = Engine(device=args.device, ckpt=args.ckpt,
                        ckpt_dirs=[args.ckpt_dir or DEFAULT_CKPT_DIR], vae_path=args.vae_path)
        engine.sd_model           # load now: a checkpoint that fails fails at start
    upscalers = register_esrgan_dir((args.esrgan_models_path, args.realesrgan_models_path),
                                    device=engine.device)
    server = make_server(engine, args.host, args.port)
    extras = "".join(f", refiner {t!r}" for t in engine._extra_models) + \
        "".join(f", upscaler {n!r}" for n in upscalers)
    print(f"serving {engine.sd_model.title!r}{extras} on "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
