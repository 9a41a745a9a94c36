"""Parameter initialisation as flax draws it (``flax.linen`` defaults), so
that a run of the port from scratch starts from the distribution a JAX run
starts from: kernels from ``lecun_normal`` (a normal truncated at 2
standard deviations, scaled so that its standard deviation is
sqrt(1 / fan_in)), biases 0, GroupNorm scales 1 and biases 0, and the
spatial transformers' last Dense all zeros (``kernel_init=zeros``).  The
fan-in is flax's: the input features of a Dense, the input channels times
the kernel's taps of a Conv or ConvTranspose."""
from __future__ import annotations

import math
import re

import torch
from torch import nn

# the standard deviation of a unit normal truncated to (-2, 2)
TRUNC_STD = 0.87962566103423978
_ZERO_KERNEL = re.compile(r"(^|\.)STN_\d+\.Dense_0$")


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv3d, nn.ConvTranspose3d)):
            m.bias.zero_()
            if _ZERO_KERNEL.search(name):
                m.weight.zero_()
                continue
            if isinstance(m, nn.Linear):
                fan_in = m.in_features
            else:
                fan_in = m.in_channels * math.prod(m.kernel_size)
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
