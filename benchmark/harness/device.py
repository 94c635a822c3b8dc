"""The card a run stands on, and what a run may not hold."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Iterable, List

# top-level module names a run of the port may not load, compared whole:
# ray_tpu_torch begins with ray_tpu and is the program
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_modules(modules: Iterable[str]) -> List[str]:
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def keep_jax_out() -> None:
    """Libraries that load JAX by themselves when they find it are told
    not to (transformers' flag), in this process and the ones it starts."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def cache_dirs(root: Path) -> None:
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its CUDA kernels into ray_tpu_torch/_build/ by itself)."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))


def card_or_exit(chips: int) -> None:
    """Exit without a result unless this machine has the cell's cards."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        sys.exit(f"the cell asks for {chips} cards, this machine has "
                 f"{torch.cuda.device_count()}")


def power_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"
