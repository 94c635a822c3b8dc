"""ray_tpu_torch.ops — hand-written CUDA kernels and their plain versions.

Each op ships (a) a plain PyTorch version (used for CPU tensors and as the
ground truth in tests) and (b) a CUDA C++ kernel for Hopper (``csrc/``),
launched for CUDA tensors.
"""

from .attention import dot_product_attention, flash_attention  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
