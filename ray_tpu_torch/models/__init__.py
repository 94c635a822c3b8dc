"""ray_tpu_torch.models — the decoder-only transformer and its train step.

Flagship: ``gpt.py`` covers the GPT-2 and Llama families through config
switches, with the JAX model's parameter layout (``convert.py`` loads a
JAX checkpoint; ``moe.py`` is the mixture-of-experts FFN that
``n_experts > 0`` selects). Training step + optimizer live in
``training.py``.
"""

from .gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    gpt2_small,
    gpt2_medium,
    gpt2_large,
    llama_tiny,
    llama_1b,
    llama_7b,
)
from .moe import moe_ffn  # noqa: F401
from .training import (  # noqa: F401
    TrainState,
    make_optimizer,
    make_train_step,
    init_train_state,
)
