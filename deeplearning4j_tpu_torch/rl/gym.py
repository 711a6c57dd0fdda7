"""Gym environment adapter — the port of ``deeplearning4j_tpu/rl/gym.py``, a
copy of its host code.

Reference: rl4j ``rl4j-gym`` (``GymEnv`` — wraps an OpenAI Gym env behind
the MDP interface so every learner runs against it; SURVEY.md §2.7).
``gym``/``gymnasium`` is imported lazily — the adapter also accepts any
already-constructed object with the (reset, step, action_space,
observation_space) protocol, which is what the tests drive with a fake.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from deeplearning4j_tpu_torch.rl.mdp import (MDP, DiscreteSpace,
                                             ObservationSpace, StepReply)

__all__ = ["GymEnv"]


def _make(envId: str):
    try:
        import gymnasium as gym
    except ImportError:
        try:
            import gym  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "GymEnv needs `gymnasium` (or legacy `gym`) installed, or "
                "pass an already-constructed env object") from e
    return gym.make(envId)


class GymEnv(MDP):
    """``GymEnv("CartPole-v1")`` or ``GymEnv(env=my_env_object)``."""

    def __init__(self, envId: Optional[str] = None, env: Any = None,
                 seed: Optional[int] = None):
        if env is None:
            if envId is None:
                raise ValueError("GymEnv needs envId or env")
            env = _make(envId)
        self.envId = envId
        self.env = env
        self._seed = seed
        self._done = False
        n = getattr(env.action_space, "n", None)
        if n is None:
            raise ValueError("GymEnv supports discrete action spaces "
                             "(reference GymEnv limitation too)")
        self._action_space = DiscreteSpace(int(n),
                                           seed=seed if seed else 0)
        shape = tuple(getattr(env.observation_space, "shape", ()) or ())
        self._obs_space = ObservationSpace(shape)

    def getObservationSpace(self) -> ObservationSpace:
        return self._obs_space

    def getActionSpace(self) -> DiscreteSpace:
        return self._action_space

    def reset(self):
        self._done = False
        out = self.env.reset(seed=self._seed) if self._seed is not None \
            else self.env.reset()
        self._seed = None            # gym semantics: seed applies once
        obs = out[0] if isinstance(out, tuple) else out
        return np.asarray(obs, np.float32)

    def step(self, action: int) -> StepReply:
        out = self.env.step(int(action))
        if len(out) == 5:            # gymnasium: obs, r, terminated, truncated, info
            obs, reward, terminated, truncated, info = out
            done = bool(terminated or truncated)
        else:                        # legacy gym: obs, r, done, info
            obs, reward, done, info = out
            done = bool(done)
        self._done = done
        return StepReply(np.asarray(obs, np.float32), float(reward), done,
                         info)

    def isDone(self) -> bool:
        return self._done

    def close(self) -> None:
        if hasattr(self.env, "close"):
            self.env.close()

    def newInstance(self) -> "GymEnv":
        if self.envId is not None:
            return GymEnv(self.envId)
        import copy
        return GymEnv(env=copy.deepcopy(self.env))
