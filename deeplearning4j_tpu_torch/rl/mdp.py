"""MDP interface + built-in environments — the port of
``deeplearning4j_tpu/rl/mdp.py``, a copy of its host numpy (the
environments' ``RandomState`` draws and float32 observations unchanged).

Reference: rl4j-core ``org/deeplearning4j/rl4j/mdp/MDP.java`` (+ the
gym/toy adapters like ``mdp/toy/SimpleToy.java`` and
``space/{DiscreteSpace,ObservationSpace}.java``).  The reference wraps
OpenAI gym via JavaCPP; here zero-egress built-ins (CartPole with the
standard dynamics, a chain toy MDP) serve development and tests — any
object with the same duck-typed surface (reset/step/isDone/getActionSpace)
plugs in.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class DiscreteSpace:
    """Reference: space/DiscreteSpace.java."""

    def __init__(self, size: int, seed: int = 0):
        self._size = size
        self._rng = np.random.RandomState(seed)

    def getSize(self) -> int:
        return self._size

    def randomAction(self) -> int:
        return int(self._rng.randint(self._size))

    def noOp(self) -> int:
        return 0


class ObservationSpace:
    """Reference: space/ObservationSpace.java — shape metadata."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(shape)


class StepReply:
    """Reference: gym StepReply — (observation, reward, done, info)."""

    def __init__(self, observation, reward: float, done: bool, info=None):
        self.observation = observation
        self.reward = reward
        self.done = done
        self.info = info

    def getObservation(self):
        return self.observation

    def getReward(self) -> float:
        return self.reward

    def isDone(self) -> bool:
        return self.done


class MDP:
    """SPI: reset/step/isDone/getObservationSpace/getActionSpace/newInstance."""

    def getObservationSpace(self) -> ObservationSpace:
        raise NotImplementedError

    def getActionSpace(self) -> DiscreteSpace:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def step(self, action: int) -> StepReply:
        raise NotImplementedError

    def isDone(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def newInstance(self) -> "MDP":
        raise NotImplementedError


class CartPole(MDP):
    """Classic cart-pole balancing (the standard Barto-Sutton dynamics the
    gym 'CartPole-v1' task uses); episode ends past +/-12 deg or +/-2.4 m
    or after maxSteps.  Reward 1 per step."""

    def __init__(self, seed: int = 0, maxSteps: int = 200):
        self._rng = np.random.RandomState(seed)
        self.maxSteps = maxSteps
        self._obs_space = ObservationSpace((4,))
        self._act_space = DiscreteSpace(2, seed)
        self._state = None
        self._steps = 0
        self._done = True

    def getObservationSpace(self):
        return self._obs_space

    def getActionSpace(self):
        return self._act_space

    def reset(self):
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        self._done = False
        return self._state.astype(np.float32)

    def step(self, action: int) -> StepReply:
        g, mc, mp, l, f, dt = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
        x, xd, th, thd = self._state
        force = f if action == 1 else -f
        cos, sin = np.cos(th), np.sin(th)
        tmp = (force + mp * l * thd ** 2 * sin) / (mc + mp)
        thacc = (g * sin - cos * tmp) / (l * (4.0 / 3.0 - mp * cos ** 2 /
                                              (mc + mp)))
        xacc = tmp - mp * l * thacc * cos / (mc + mp)
        x, xd = x + dt * xd, xd + dt * xacc
        th, thd = th + dt * thd, thd + dt * thacc
        self._state = np.array([x, xd, th, thd])
        self._steps += 1
        self._done = bool(abs(x) > 2.4 or abs(th) > 12 * np.pi / 180
                          or self._steps >= self.maxSteps)
        return StepReply(self._state.astype(np.float32), 1.0, self._done)

    def isDone(self) -> bool:
        return self._done

    def newInstance(self) -> "CartPole":
        return CartPole(seed=self._rng.randint(1 << 30),
                        maxSteps=self.maxSteps)


class ChainMDP(MDP):
    """Tiny deterministic chain (reference analogue: mdp/toy/SimpleToy) —
    n states in a line; RIGHT reaches the goal (+10), LEFT pays 0.1.
    Optimal return is known, handy for convergence asserts."""

    def __init__(self, n: int = 6, maxSteps: int = 30, seed: int = 0):
        self.n = n
        self.maxSteps = maxSteps
        self._obs_space = ObservationSpace((n,))
        self._act_space = DiscreteSpace(2, seed)
        self._pos = 0
        self._steps = 0
        self._done = True

    def _obs(self):
        v = np.zeros(self.n, dtype=np.float32)
        v[self._pos] = 1.0
        return v

    def getObservationSpace(self):
        return self._obs_space

    def getActionSpace(self):
        return self._act_space

    def reset(self):
        self._pos = 0
        self._steps = 0
        self._done = False
        return self._obs()

    def step(self, action: int) -> StepReply:
        reward = 0.0
        if action == 1:
            self._pos += 1
            if self._pos >= self.n - 1:
                reward = 10.0
                self._done = True
        else:
            self._pos = max(0, self._pos - 1)
            reward = 0.1
        self._steps += 1
        if self._steps >= self.maxSteps:
            self._done = True
        return StepReply(self._obs(), reward, self._done)

    def isDone(self) -> bool:
        return self._done

    def newInstance(self) -> "ChainMDP":
        return ChainMDP(self.n, self.maxSteps)
