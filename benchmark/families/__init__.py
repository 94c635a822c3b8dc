"""Model families: a configuration file's keys, read into `Dims`, and what
a family supplies of its own.

A family is the module ``families/<model_type>.py``. It holds
``dims(config) -> Dims`` (a subclass of `Dims` with fields of its own
where it needs them) and the CPU tests' sizes, ``TINY`` (configuration
keys) and ``TINY_ASSUMED`` (keys of its ``assumed``). It may hold any of
these, with the default where it does not:

- ``leaves(d)``: (name, shape, init) of every parameter in draw order
  (default `reference.common.leaves`, the dense block), looked up here;
- ``port_kwargs(d)``: keyword arguments added to the port's
  ``GPTConfig`` that `harness.program.gpt_config` builds (default none),
  looked up here;
- ``train_flops_per_token(d, seq)``, read by `harness.roofline.mfu`
  (default `harness.flops.train_flops_per_token`).

A family's ``port_kwargs`` adds settings; it may not replace one that
``gpt_config`` takes from the configuration (the precision, remat, z-loss,
the norm and the sizes), and ``gpt_config`` refuses a family that tries.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import List, Tuple, Union

from ..reference import common
from ..reference.common import Dims

Leaf = Tuple[str, Tuple[int, ...], str]


def module(of: Union[dict, Dims]) -> ModuleType:
    """The family module of a configuration (its ``model_type``) or of a
    `Dims` (its ``family``)."""
    name = of.family if isinstance(of, Dims) else of["model_type"]
    return importlib.import_module(f"{__name__}.{name}")


def dims(config: dict) -> Dims:
    return module(config).dims(config)


def leaves(d: Dims) -> List[Leaf]:
    return getattr(module(d), "leaves", common.leaves)(d)


def groups(d: Dims) -> List[List[Leaf]]:
    """`leaves` cut into the groups drawn by one call each: the leaves
    outside the blocks, then one group a block."""
    all_leaves = leaves(d)
    out = [[x for x in all_leaves if not x[0].startswith("blocks.")]]
    for i in range(d.n_layers):
        out.append([x for x in all_leaves
                    if x[0].startswith(f"blocks.{i}.")])
    return out


def port_kwargs(d: Dims) -> dict:
    return dict(getattr(module(d), "port_kwargs", lambda _: {})(d))
