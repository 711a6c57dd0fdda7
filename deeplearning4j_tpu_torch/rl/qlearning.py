"""Deep Q-learning (DQN / double DQN) + experience replay + policies — the
port of ``deeplearning4j_tpu/rl/qlearning.py``.

Reference: rl4j-core ``org/deeplearning4j/rl4j/learning/sync/qlearning/
discrete/QLearningDiscreteDense.java`` (+ ``QLearning.QLConfiguration``,
``ExpReplay``, ``policy/{DQNPolicy,EpsGreedy}.java`` and the
``DQNFactoryStdDense`` net factory).

The DQN update flows through the port's ``MultiLayerNetwork``: one
Bellman step is three forwards (online on the batch, online and target on
the next observations) under ``no_grad``, the double-DQN or vanilla
target, then the net's own train step on (obs, y).  ``y`` is built under
``no_grad``, so the loss never differentiates through the labels.  The
target network is a detached copy of ``params_`` (fresh storage, so no
update of the online net can move it), refreshed every
``targetDqnUpdateFreq`` environment steps.  The replay, the epsilon-greedy
draws and the environments keep the reference's host generators
(``random.Random`` / ``np.random.RandomState``); dropout draws from the
net's ``_fitGen`` (ROADMAP C33).
"""
from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.learning.config import Adam
from deeplearning4j_tpu_torch.models.multilayer import (MultiLayerNetwork,
                                                        _tree_map)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.rl.mdp import MDP
from deeplearning4j_tpu_torch.rl.policy import Policy


@dataclasses.dataclass
class QLConfiguration:
    """Reference: QLearning.QLConfiguration (builder fields)."""
    seed: int = 123
    maxEpochStep: int = 200
    maxStep: int = 15000
    expRepMaxSize: int = 15000
    batchSize: int = 64
    targetDqnUpdateFreq: int = 100
    updateStart: int = 100
    rewardFactor: float = 1.0
    gamma: float = 0.99
    errorClamp: float = 1.0
    minEpsilon: float = 0.05
    epsilonNbStep: int = 3000
    doubleDQN: bool = True


class ExpReplay:
    """Reference: learning/sync/ExpReplay.java — uniform ring buffer."""

    def __init__(self, maxSize: int, batchSize: int, seed: int = 0):
        self._buf: deque = deque(maxlen=maxSize)
        self.batchSize = batchSize
        self._rng = random.Random(seed)

    def store(self, obs, action, reward, nextObs, done) -> None:
        self._buf.append((obs, action, reward, nextObs, done))

    def getBatch(self, size: Optional[int] = None) -> List:
        size = size or self.batchSize
        return self._rng.sample(self._buf, min(size, len(self._buf)))

    def __len__(self):
        return len(self._buf)


class EpsGreedy:
    """Reference: policy/EpsGreedy.java — linear decay to minEpsilon."""

    def __init__(self, minEpsilon: float, epsilonNbStep: int, seed: int = 0):
        self.minEpsilon = minEpsilon
        self.epsilonNbStep = max(1, epsilonNbStep)
        self._rng = np.random.RandomState(seed)

    def epsilon(self, step: int) -> float:
        frac = min(1.0, step / self.epsilonNbStep)
        return 1.0 + frac * (self.minEpsilon - 1.0)

    def nextAction(self, qvals: np.ndarray, step: int) -> int:
        if self._rng.rand() < self.epsilon(step):
            return int(self._rng.randint(qvals.shape[-1]))
        return int(np.argmax(qvals))


class DQNPolicy(Policy):
    """Greedy policy over a trained Q-network (reference: DQNPolicy.java)."""

    def __init__(self, net: MultiLayerNetwork):
        self.net = net

    def nextAction(self, obs) -> int:
        q = self.net._output(np.asarray(obs, np.float32)[None])
        return int(torch.argmax(q[0]))


def _dqn_factory(nIn: int, nOut: int, seed: int, lr: float = 1e-3,
                 hidden=(64, 64), device=None) -> MultiLayerNetwork:
    """Reference: network/dqn/DQNFactoryStdDense — MLP with identity-MSE
    head (Q-values are unbounded regression targets), on ``device``
    (``cuda`` unless given)."""
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(lr))
         .weightInit("XAVIER").list())
    prev = nIn
    for h in hidden:
        b.layer(DenseLayer.builder().nIn(prev).nOut(h).activation("relu")
                .build())
        prev = h
    b.layer(OutputLayer.builder("mse").nIn(prev).nOut(nOut)
            .activation("identity").build())
    return MultiLayerNetwork(b.build(), device=device).init()


def _snapshot(params):
    """A detached copy of a parameter tree in storage of its own."""
    return _tree_map(lambda t: t.detach().clone(), params)


class QLearningDiscreteDense:
    """Reference: QLearningDiscreteDense.java — sync DQN training loop.

    ``net`` (a ``MultiLayerNetwork`` with an identity-MSE head) is trained
    where it lies; without one, the factory's net is built on ``device``
    (``cuda`` unless given)."""

    def __init__(self, mdp: MDP, conf: Optional[QLConfiguration] = None,
                 net: Optional[MultiLayerNetwork] = None, hidden=(64, 64),
                 device=None):
        self.mdp = mdp
        self.conf = conf or QLConfiguration()
        nIn = int(np.prod(mdp.getObservationSpace().shape))
        nOut = mdp.getActionSpace().getSize()
        self.net = net or _dqn_factory(nIn, nOut, self.conf.seed,
                                       hidden=hidden, device=device)
        self.replay = ExpReplay(self.conf.expRepMaxSize, self.conf.batchSize,
                                self.conf.seed)
        self.egreedy = EpsGreedy(self.conf.minEpsilon,
                                 self.conf.epsilonNbStep, self.conf.seed)
        self._target = _snapshot(self.net.params_)
        self.stepCount = 0
        self.epochRewards: List[float] = []

    # -- target net -------------------------------------------------------
    def _refresh_target(self) -> None:
        self._target = _snapshot(self.net.params_)

    def _q(self, params, obs_batch) -> torch.Tensor:
        """Inference-mode Q-values of ``params`` (float32, on the net's
        device)."""
        net = self.net
        with torch.no_grad():
            x = net._on_device(obs_batch, torch.float32)
            out, _, _ = net._forward(net._cast_compute(params), net.state_,
                                     net._cast_compute(x), False, None)
        return out.float()

    # -- Bellman update through the net's train step ------------------------
    def _labels(self, obs, acts, rews, nxt, done) -> torch.Tensor:
        """The regression labels: the online Q-values of ``obs`` with each
        taken action's entry moved by the clamped TD error.  Built under
        ``no_grad``: to the train step they are constants."""
        net, c = self.net, self.conf
        n = obs.shape[0]
        rows = torch.arange(n, device=obs.device)
        with torch.no_grad():
            q_cur, _, _ = net._forward(net.params_, net.state_, obs, False,
                                       None)
            q_no, _, _ = net._forward(net.params_, net.state_, nxt, False,
                                      None)
            q_nt, _, _ = net._forward(self._target, net.state_, nxt, False,
                                      None)
            if c.doubleDQN:
                boot = q_nt[rows, torch.argmax(q_no, dim=1)]
            else:
                boot = q_nt.max(dim=1).values
            tgt = rews * c.rewardFactor + c.gamma * boot * (1.0 - done)
            td = tgt - q_cur[rows, acts]
            if c.errorClamp:
                td = torch.clamp(td, -c.errorClamp, c.errorClamp)
            return q_cur.index_put((rows, acts), td, accumulate=True)

    def _train_batch(self) -> None:
        batch = self.replay.getBatch()
        net = self.net
        obs = net._on_device(np.stack([b[0] for b in batch]), torch.float32)
        acts = net._on_device(np.array([b[1] for b in batch], np.int64))
        rews = net._on_device(np.array([b[2] for b in batch], np.float32))
        nxt = net._on_device(np.stack([b[3] for b in batch]), torch.float32)
        done = net._on_device(np.array([b[4] for b in batch], np.float32))
        y = self._labels(obs, acts, rews, nxt, done)
        net._runTrainStep(obs, y, None, None)
        net.iterationCount += 1

    # -- training loop ------------------------------------------------------
    def train(self) -> None:
        while self.stepCount < self.conf.maxStep:
            obs = self.mdp.reset()
            ep_reward = 0.0
            for _ in range(self.conf.maxEpochStep):
                q = self._q(self.net.params_, obs[None])[0].cpu().numpy()
                action = self.egreedy.nextAction(q, self.stepCount)
                reply = self.mdp.step(action)
                self.replay.store(obs, action, reply.getReward(),
                                  reply.getObservation(), reply.isDone())
                obs = reply.getObservation()
                ep_reward += reply.getReward()
                self.stepCount += 1
                if self.stepCount >= self.conf.updateStart and \
                        len(self.replay) >= self.conf.batchSize:
                    self._train_batch()
                if self.stepCount % self.conf.targetDqnUpdateFreq == 0:
                    self._refresh_target()
                if reply.isDone() or self.stepCount >= self.conf.maxStep:
                    break
            self.epochRewards.append(ep_reward)

    def getPolicy(self) -> DQNPolicy:
        return DQNPolicy(self.net)
