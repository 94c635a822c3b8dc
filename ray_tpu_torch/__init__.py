"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

A package of its own beside ``ray_tpu``: it imports ``torch`` and
``numpy`` and nothing of JAX or of ``ray_tpu``. It holds the flagship
decoder's training step (``models``), with its attention on hand-written
CUDA flash kernels and ring attention over them (``ops``), on one device or
over a dp x fsdp x tp x sp mesh (``parallel``), and the RL compute core
(``rl``: the policy and Q modules, the PPO, V-trace and double-DQN learners,
GAE, replay buffers and the env runners' sampling). Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; callers
that sample on the CPU as the JAX runners do pass it to the env runners.
"""

from . import models, ops, parallel, rl  # noqa: F401

__version__ = "0.1.0"
