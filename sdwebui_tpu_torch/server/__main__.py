"""Run the txt2img API server.

    python -m sdwebui_tpu_torch.server --port 7860 --device cuda [--tiny]

Without a checkpoint loader the model is random-weight SD1.5 at full width
(or the tiny test model with ``--tiny``), made from ``--seed``.
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
    ap.add_argument("--tiny", action="store_true", help="serve the tiny test model")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)
    server = make_server(Engine(device=args.device, tiny=args.tiny, seed=args.seed),
                         args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
