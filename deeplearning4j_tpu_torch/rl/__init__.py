"""Reinforcement learning — the port of ``deeplearning4j_tpu/rl`` (reference:
rl4j): the environments, DQN, A3C (batched and threaded), async n-step
Q-learning with the Atari-style history pipeline, and the Gym, Malmo and
ViZDoom adapters.  Learners run on ``cuda`` unless given ``device=``."""
from deeplearning4j_tpu_torch.rl.mdp import (  # noqa: F401
    CartPole, ChainMDP, DiscreteSpace, MDP, ObservationSpace, StepReply)
from deeplearning4j_tpu_torch.rl.qlearning import (  # noqa: F401
    DQNPolicy, EpsGreedy, ExpReplay, QLConfiguration,
    QLearningDiscreteDense)
from deeplearning4j_tpu_torch.rl.policy import (  # noqa: F401
    Policy, softmax_sample)
from deeplearning4j_tpu_torch.rl.a3c import (  # noqa: F401
    A3CConfiguration, A3CDiscreteDense, A3CDiscreteDenseAsync, ACPolicy,
    ActorCriticSeparate)
from deeplearning4j_tpu_torch.rl.gym import GymEnv  # noqa: F401
from deeplearning4j_tpu_torch.rl.async_nstep_q import (  # noqa: F401
    AsyncNStepQLearningDiscrete, AsyncQLearningConfiguration, HistoryMDP,
    HistoryProcessor, HistoryProcessorConfiguration, PixelCartPole)
from deeplearning4j_tpu_torch.rl.envs import MalmoEnv, VizdoomEnv  # noqa: F401
