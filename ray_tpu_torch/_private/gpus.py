"""The CUDA devices a process sees, counted without torch and without a
CUDA context: a node process (``_private/main.py``) and a driver's
``init()`` count the cards for their ``"GPU"`` resource this way, and
only the workers given a slot ever touch a card."""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional


def _physical_gpu_count() -> int:
    """NVIDIA devices on this host: NVML's count (through ctypes, which
    opens no CUDA context), else the driver's ``/proc`` entries; 0 where
    there is no NVIDIA driver."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        nvml = None
    if nvml is not None:
        count = ctypes.c_uint(0)
        try:
            if nvml.nvmlInit_v2() == 0:
                try:
                    if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) == 0:
                        return int(count.value)
                finally:
                    nvml.nvmlShutdown()
        except AttributeError:
            pass
    try:
        return len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        return 0


def visible_gpu_count(visible: Optional[str] = None,
                      physical: Optional[int] = None) -> int:
    """CUDA devices this process sees: ``CUDA_VISIBLE_DEVICES`` (or
    ``visible``) read as CUDA reads it, over the host's devices. Unset:
    every device. Set: its entries up to the first that names no device
    (an index out of range, or anything that is neither an index nor a
    ``GPU-``/``MIG-`` UUID); an empty value hides them all."""
    if visible is None:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    n = _physical_gpu_count() if physical is None else physical
    if n == 0 or visible is None:
        return n
    seen: List[str] = []
    for entry in visible.split(","):
        entry = entry.strip()
        if entry.startswith(("GPU-", "MIG-")):
            pass
        elif not entry.isdigit() or int(entry) >= n:
            break
        if entry in seen:
            break
        seen.append(entry)
    return len(seen)
