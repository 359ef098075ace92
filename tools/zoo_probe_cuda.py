"""Where the upscaler zoo's forward time goes on one card.

    python3 tools/zoo_probe_cuda.py [NAME ...]

For each net at its published widths (chip_smoke's seeded files: SwinIR-L,
Swin2SR, Real_HAT_GAN_SRx4, DAT x4, SCUNet; NAME picks some), loaded
through its ``*_from_state_dict`` as a file is, on the 9 tiles of a 512²
image (192², SCUNet 256²): the ms of one forward (CUDA events, median of
three), with the 4-D weights as loaded and again made channels-last, and
one forward's device time by kernel class and its top kernels under
torch.profiler.  For LDSR ("LDSR"): one UNet step at a 256² latent (bf16)
and the VQ decode to 1024², the same way.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def event_ms(fn, n: int = 3) -> float:
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def kernels(fn, top: int = 12) -> dict:
    """Device ms of one call by kernel class and the top kernels."""
    import chip_smoke

    return chip_smoke.kernel_times(fn, top)


def channels_last_(net: torch.nn.Module) -> None:
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)


def main(names) -> int:
    if not torch.cuda.is_available():
        print("zoo_probe_cuda: needs a CUDA card", file=sys.stderr)
        return 1
    from sdwebui_tpu_torch.models import dat, hat, ldsr, scunet, swin2sr, swinir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    nets = {
        "SwinIR-L": (lambda: swinir.create_random_swinir(20, dev), swinir.swinir_from_state_dict),
        "Swin2SR": (lambda: swin2sr.create_random_swin2sr(21, dev),
                    swin2sr.swin2sr_from_state_dict),
        "HAT": (lambda: hat.create_random_hat(22, dev), hat.hat_from_state_dict),
        "DAT": (lambda: dat.create_random_dat(23, dev),
                lambda sd, d: dat.dat_from_state_dict(sd, d, (8, 32))),
        "SCUNet": (lambda: scunet.create_random_scunet(24, dev), scunet.scunet_from_state_dict),
    }
    out = {"card": torch.cuda.get_device_name(0)}
    for name, (make, load) in nets.items():
        if names and name not in names:
            continue
        sd = {k: v.detach().cpu() for k, v in make().state_dict().items()}
        net = load(sd, dev)
        size = 256 if name == "SCUNet" else 192
        x = torch.rand((9, size, size, 3), generator=torch.Generator().manual_seed(1)).to(dev)
        with torch.inference_mode():
            loaded = event_ms(lambda: net(x))
            prof = kernels(lambda: net(x))
            channels_last_(net)
            cl = event_ms(lambda: net(x))
            prof_cl = kernels(lambda: net(x))
        out[name] = dict(ms_as_loaded=loaded, ms_channels_last=cl, as_loaded=prof,
                         channels_last=prof_cl)
        print(name, json.dumps(out[name], default=str)[:3000], flush=True)
        del net, sd
        torch.cuda.empty_cache()
    if not names or "LDSR" in names:
        sd = ldsr.ldsr_state_dict(ldsr.create_random_ldsr(25, dev))
        model = ldsr.ldsr_from_state_dict({k: v.cpu() for k, v in sd.items()}, dev)
        del sd
        x = torch.randn((1, 6, 256, 256), device=dev).bfloat16()
        t = torch.full((1,), 981.0, device=dev)
        z = torch.randn((1, 3, 256, 256), device=dev) * 3
        with torch.inference_mode():
            res = {}
            for arm in ("as_loaded", "channels_last"):
                if arm == "channels_last":
                    channels_last_(model)
                res[arm] = dict(
                    unet_ms=event_ms(lambda: model.unet(x, t, None), 5),
                    unet=kernels(lambda: model.unet(x, t, None)),
                    vq_ms=event_ms(lambda: model.vq.vq_decode(z)),
                    vq=kernels(lambda: model.vq.vq_decode(z)))
        out["LDSR"] = res
        print("LDSR", json.dumps(res, default=str)[:4000], flush=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
