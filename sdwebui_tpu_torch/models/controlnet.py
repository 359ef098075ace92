"""ControlNet: the conditioning tower that gives the UNet its residuals.

Port of ``sdwebui_tpu/models/controlnet.py:44-128``.  Parameter names are
the official ``control_model.*`` keys with the prefix stripped:

    time_embed.{0,2}, label_emb.0.{0,2}   as the UNet (label_emb: SDXL)
    input_blocks.*, middle_block.*        as the UNet's encoder
    input_hint_block.{0,2,..,14}          8 convs, SiLU between, strides
                                          1,1,2,1,2,1,2,1 (image → latent grid)
    zero_convs.{i}.0                      a 1×1 conv per input block
    middle_block_out.0                    a 1×1 conv

The hint enters after the first input block (cldm's guided hint); the
residuals are ``{"input": (one per input block), "middle": ...}``, which
``UNetModel.forward(control=)`` adds the cldm way.
"""

from __future__ import annotations

import torch
from torch import nn

from sdwebui_tpu_torch.models.configs import UNetConfig
from sdwebui_tpu_torch.models.layers import Conv2d
from sdwebui_tpu_torch.models.unet import UNetEncoder, build_plan, run_layers

HINT_STRIDES = (1, 1, 2, 1, 2, 1, 2, 1)
HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)   # then model_channels


class ControlNetModel(UNetEncoder):
    kind = "ControlNet"

    def __init__(self, cfg: UNetConfig, hint_channels: int = 3, *, device, dtype):
        if cfg.tiling:      # JAX's tower pads with zeros whatever the request asks
            raise NotImplementedError(f"{self.kind} option not ported yet: tiling")
        super().__init__(cfg, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        _, _, _, input_chs = build_plan(cfg)
        chans = (hint_channels,) + HINT_CHANNELS + (cfg.model_channels,)
        hint = []
        for j, stride in enumerate(HINT_STRIDES):
            hint.append(Conv2d(chans[j], chans[j + 1], 3, stride=stride, **kw))
            if j < len(HINT_STRIDES) - 1:
                hint.append(nn.SiLU())
        self.input_hint_block = nn.Sequential(*hint)
        self.zero_convs = nn.ModuleList(nn.Sequential(Conv2d(c, c, 1, **kw))
                                        for c in input_chs)
        self.middle_block_out = nn.Sequential(Conv2d(input_chs[-1], input_chs[-1], 1, **kw))
        self.hint_channels = hint_channels

    def forward(self, x, timesteps, context, hint, y=None):
        """x: (B, C, H, W) the UNet's scaled latent input; hint: (B,
        hint_channels, 8H, 8W) in [0, 1] → {"input": tuple, "middle": tensor}."""
        emb = self.embed(timesteps, y, x.dtype)
        context = context.to(x.dtype)
        guided = self.input_hint_block(hint.to(x.dtype).contiguous(
            memory_format=torch.channels_last))
        h = x.contiguous(memory_format=torch.channels_last)
        outs = []
        for i, (block, zero_conv) in enumerate(zip(self.input_blocks, self.zero_convs)):
            h = run_layers(block, h, emb, context)
            if i == 0:
                h = h + guided
            outs.append(zero_conv(h))
        h = run_layers(self.middle_block, h, emb, context)
        return {"input": tuple(outs), "middle": self.middle_block_out(h)}
