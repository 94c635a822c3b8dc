"""ray_tpu_torch.rl — ``ray_tpu.rl`` on the port's runtime.

The learners' updates run on the card (``Learner`` with the PPO or V-trace
loss, ``DQNLearner`` with double DQN), in process or in actors with a GPU
slot each (``LearnerGroup``), as the JAX learners run theirs as one jitted
program on the accelerator. The env runners (``EnvRunner`` over a
``VectorEnv``) run as actors (``EnvRunner.remote``) that sample on the
host, as the JAX runners do; in process they default to the card like
every entry point, and sample on the host when passed ``device="cpu"``.
``PPO``, ``Impala`` and ``DQN`` with their builder configs drive both.
The modules (``DiscretePolicyModule``, ``QNetworkModule``) keep the JAX
parameter layout, and ``convert`` maps JAX weights to and from them.
``env``, ``sample_batch`` (with ``compute_gae``) and ``replay_buffers``
are the port's numpy copies.

One export differs from JAX's: ``ReplayBuffer`` is the uniform buffer of
``replay_buffers.py`` (JAX exports that one as ``UniformReplayBuffer``,
which the port exports too); DQN's replay actor is ``dqn.ReplayBuffer``.
``OfflineDQN`` waits for the port's ``data``.
"""

from .convert import params_from_jax, params_to_jax  # noqa: F401
from .dqn import NEXT_OBS, DQN, DQNConfig, DQNLearner  # noqa: F401
from .env import CartPoleEnv, Env, RandomEnv  # noqa: F401
from .impala import Impala, ImpalaConfig  # noqa: F401
from .learner import Learner, LearnerGroup  # noqa: F401
from .module import DiscretePolicyModule, QNetworkModule  # noqa: F401
from .ppo import PPO, PPOConfig  # noqa: F401
from .replay_buffers import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
    ReplayBuffer as UniformReplayBuffer,
)
from .sample_batch import SampleBatch, compute_gae, concat_batches  # noqa: F401
from .vector_env import EnvRunner, VectorEnv  # noqa: F401
