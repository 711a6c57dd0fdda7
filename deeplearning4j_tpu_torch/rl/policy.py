"""Shared policy machinery — the port of ``deeplearning4j_tpu/rl/policy.py``,
a copy of its host numpy.

Reference: rl4j-core ``org/deeplearning4j/rl4j/policy/Policy.java`` — the
base ``play`` rollout loop every concrete policy (DQNPolicy, ACPolicy)
inherits.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.rl.mdp import MDP


def softmax_sample(rng: np.random.RandomState, logits: np.ndarray) -> int:
    """Draw an action from softmax(logits) — the ONE canonical sampler."""
    p = np.exp(logits - logits.max())
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


class Policy:
    """SPI: nextAction(obs) -> int; play() runs one episode."""

    def nextAction(self, obs) -> int:
        raise NotImplementedError

    def play(self, mdp: MDP, maxSteps: int = 10_000) -> float:
        obs = mdp.reset()
        total = 0.0
        for _ in range(maxSteps):
            reply = mdp.step(self.nextAction(obs))
            total += reply.getReward()
            obs = reply.getObservation()
            if reply.isDone():
                break
        return total
