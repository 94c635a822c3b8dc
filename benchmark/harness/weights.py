"""Weights and tokens from the seed, made on the device.

The weights are drawn one group at a time (the leaves outside the blocks,
then one group a block), each group by one call of a `torch.Generator` on
the device seeded from (seed, group): a few large calls, and any group can
be drawn again alone, as the check does after the program's state is gone.
Tokens are drawn the same way, one call a step or a request.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator

import torch

from ..families import groups
from ..reference.common import Dims

_MASK = (1 << 63) - 1


def mix(seed: int, *keys: int) -> int:
    """A generator seed for (seed, *keys): splitmix64 over each in turn,
    so nearby seeds and keys give unrelated streams."""
    x = int(seed) & ((1 << 64) - 1)
    for k in keys:
        x = (x + 0x9E3779B97F4A7C15 + int(k)) & ((1 << 64) - 1)
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        x ^= x >> 31
    return x & _MASK


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def draw_group(d: Dims, seed: int, index: int, device
               ) -> Dict[str, torch.Tensor]:
    """The f32 leaves of group `index` of `groups(d)` (the family's
    layout)."""
    group = groups(d)[index]
    n = sum(math.prod(shape) for _, shape, init in group
            if init in ("normal", "resid"))
    flat = torch.randn(n, generator=_generator(device, mix(seed, 1, index)),
                       device=device, dtype=torch.float32)
    resid = d.init_std / math.sqrt(2 * d.n_layers)
    out, at = {}, 0
    for name, shape, init in group:
        if init in ("normal", "resid"):
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul_(
                d.init_std if init == "normal" else resid)
            at += size
        else:
            out[name] = torch.full(shape, 1.0 if init == "one" else 0.0,
                                   device=device, dtype=torch.float32)
    return out


def draw_groups(d: Dims, seed: int, device
                ) -> Iterator[Dict[str, torch.Tensor]]:
    for index in range(len(groups(d))):
        yield draw_group(d, seed, index, device)


def draw_all(d: Dims, seed: int, device) -> Dict[str, torch.Tensor]:
    out = {}
    for g in draw_groups(d, seed, device):
        out.update(g)
    return out


def train_rows(d: Dims, seed: int, step: int, batch: int, device
               ) -> torch.Tensor:
    """The token rows [batch, seq_len] of train step `step` (from 0): uniform
    below token_ids_below, new for every step."""
    return torch.randint(0, d.token_ids_below, (batch, d.seq_len),
                         generator=_generator(device, mix(seed, 2, step)),
                         device=device, dtype=torch.long)
