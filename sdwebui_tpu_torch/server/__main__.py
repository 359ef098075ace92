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
``models/RealESRGAN``) serve as upscalers by file name, and so do the
rest of the zoo's files under ``models/SwinIR`` (SwinIR and Swin2SR),
``models/ScuNET``, ``models/LDSR``, ``models/HAT`` and ``--dat-models-path``
(default ``models/DAT``), relative to the working directory as the JAX
Engine reads them.  The face
restorers' weights are the first file under ``--gfpgan-models-path`` and
``--codeformer-models-path`` (default ``models/GFPGAN`` and
``models/Codeformer``; JAX parses both flags and never reads them).  Extra networks and
ControlNet: the LoRA / LyCORIS files under ``--lora-dir`` (default
``models/Lora`` and ``models/LyCORIS``), the hypernetworks under
``--hypernetwork-dir`` (``models/hypernetworks``), the textual-inversion
embeddings under ``--embeddings-dir`` (``embeddings``) and the ControlNet
towers under ``--controlnet-dir`` (``models/ControlNet``).  Random weights at full
width, made from ``--seed``, only with ``--model``: SD1.5, or the SDXL
base with its refiner, which requests name by its title
(``refiner_checkpoint``); ``--tiny`` for the test models.  The "Custom
code" script runs only with ``--allow-code``.
"""

from __future__ import annotations

import argparse
import os

from sdwebui_tpu_torch.networks.extra_networks import DEFAULT_LORA_DIRS, set_lora_dirs
from sdwebui_tpu_torch.networks.hypernetwork import (DEFAULT_HYPERNETWORK_DIR,
                                                     set_hypernetwork_dirs)
from sdwebui_tpu_torch.networks.textual_inversion import DEFAULT_EMBEDDINGS_DIR
from sdwebui_tpu_torch.pipeline.control import DEFAULT_CONTROLNET_DIR, set_model_dirs
from sdwebui_tpu_torch.postprocessing import faces
from sdwebui_tpu_torch.postprocessing.upscalers import register_model_dirs
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
    ap.add_argument("--dat-models-path", default=os.path.join("models", "DAT"),
                    help="Path to directory with DAT model file(s).")
    ap.add_argument("--gfpgan-models-path", default=faces.DEFAULT_DIRS["GFPGAN"][0],
                    help="Path to directory with GFPGAN model file(s).")
    ap.add_argument("--codeformer-models-path", default=faces.DEFAULT_DIRS["CodeFormer"][0],
                    help="Path to directory with codeformer model file(s).")
    ap.add_argument("--lora-dir", default=None,
                    help="Path to directory with Lora networks (default: models/Lora and "
                         "models/LyCORIS)")
    ap.add_argument("--hypernetwork-dir", default=DEFAULT_HYPERNETWORK_DIR,
                    help="hypernetwork directory")
    ap.add_argument("--embeddings-dir", default=DEFAULT_EMBEDDINGS_DIR,
                    help="embeddings directory for textual inversion (default: embeddings)")
    ap.add_argument("--controlnet-dir", default=DEFAULT_CONTROLNET_DIR,
                    help="Path to directory with ControlNet models")
    ap.add_argument("--allow-code", action="store_true",
                    help="allow custom script execution from webui")
    ap.add_argument("--tiny", action="store_true", help="with --model: the tiny test model(s)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)
    if args.model and (args.ckpt or args.ckpt_dir or args.vae_path):
        ap.error("--model serves random weights: it takes no --ckpt, --ckpt-dir or --vae-path")
    if args.tiny and not args.model:
        ap.error("--tiny needs --model")
    if args.vae_path and not os.path.isfile(args.vae_path):
        ap.error(f"--vae-path {args.vae_path!r} is not a file")
    set_lora_dirs([args.lora_dir] if args.lora_dir else DEFAULT_LORA_DIRS)
    set_hypernetwork_dirs([args.hypernetwork_dir])
    set_model_dirs([args.controlnet_dir])
    faces.set_model_dirs("GFPGAN", [args.gfpgan_models_path])
    faces.set_model_dirs("CodeFormer", [args.codeformer_models_path])
    if args.model:
        engine = Engine(device=args.device, tiny=args.tiny, seed=args.seed, family=args.model,
                        embeddings_dir=args.embeddings_dir, allow_code=args.allow_code)
    else:
        engine = Engine(device=args.device, ckpt=args.ckpt,
                        ckpt_dirs=[args.ckpt_dir or DEFAULT_CKPT_DIR], vae_path=args.vae_path,
                        embeddings_dir=args.embeddings_dir, allow_code=args.allow_code)
        engine.sd_model           # load now: a checkpoint that fails fails at start
    # ESRGAN, RealESRGAN, then models/SwinIR, ScuNET, LDSR, HAT and DAT
    upscalers, realesrgan = register_model_dirs(
        (args.esrgan_models_path, args.realesrgan_models_path), models_root="models",
        dat_dir=args.dat_models_path, device=engine.device)
    server = make_server(engine, args.host, args.port, flags=vars(args), realesrgan=realesrgan)
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
