"""ray_tpu_torch.rl — the RL compute core of ``ray_tpu.rl`` in one process.

The learners' updates run on the card (``Learner`` with the PPO or V-trace
loss, ``DQNLearner`` with double DQN), as the JAX learners run theirs as one
jitted program on the accelerator. The env runners (``EnvRunner`` over a
``VectorEnv``) default to the card like every entry point; passed
``device="cpu"``, they sample on the host as the JAX runners do. The modules
(``DiscretePolicyModule``, ``QNetworkModule``) keep the JAX parameter layout,
and ``convert`` maps JAX weights to and from them. ``env``, ``sample_batch``
(with ``compute_gae``) and ``replay_buffers`` are the port's numpy copies.

The actor forms and the algorithm classes (``LearnerGroup``, ``PPO``,
``Impala``, ``DQN``, ``OfflineDQN``) wait for the port's runtime core; a
training loop is driven by hand, as ``ray_tpu/rl/ppo.py``'s ``train`` does.
"""

from .convert import params_from_jax, params_to_jax  # noqa: F401
from .dqn import NEXT_OBS, DQNLearner  # noqa: F401
from .env import CartPoleEnv, Env, RandomEnv  # noqa: F401
from .learner import Learner  # noqa: F401
from .module import DiscretePolicyModule, QNetworkModule  # noqa: F401
from .replay_buffers import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from .sample_batch import SampleBatch, compute_gae, concat_batches  # noqa: F401
from .vector_env import EnvRunner, VectorEnv  # noqa: F401
