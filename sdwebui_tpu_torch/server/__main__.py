"""Run the API server (txt2img, img2img).

    python -m sdwebui_tpu_torch.server --port 7860 --device cuda [--model sdxl] [--tiny]

Without a checkpoint loader the models are random weights at full width
(or the tiny test models with ``--tiny``), made from ``--seed``: SD1.5, or
with ``--model sdxl`` the SDXL base plus its refiner, which requests name
by its title (``refiner_checkpoint``).
"""

from __future__ import annotations

import argparse

from sdwebui_tpu_torch.server.api import make_server
from sdwebui_tpu_torch.server.app import Engine


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sdwebui_tpu_torch.server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default="cuda", help="cuda or cpu (cuda never falls back)")
    ap.add_argument("--model", choices=("sd15", "sdxl"), default="sd15",
                    help="model family of the random weights (sdxl: base + refiner)")
    ap.add_argument("--tiny", action="store_true", help="serve the tiny test model(s)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)
    engine = Engine(device=args.device, tiny=args.tiny, seed=args.seed, family=args.model)
    server = make_server(engine, args.host, args.port)
    refiners = "".join(f", refiner {t!r}" for t in engine._extra_models)
    print(f"serving {engine.sd_model.title!r}{refiners} on "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
