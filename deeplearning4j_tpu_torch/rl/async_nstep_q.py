"""Async n-step Q-learning + HistoryProcessor — the port of
``deeplearning4j_tpu/rl/async_nstep_q.py``.

Reference: rl4j ``AsyncNStepQLearningDiscrete(Dense)`` — worker threads
roll out n steps under epsilon-greedy on a shared Q-network, bootstrap
the n-step return from a periodically-synced TARGET network, and apply
their gradients Hogwild-style to the shared params — and rl4j
``HistoryProcessor`` — the Atari-class image-observation pipeline
(grayscale downscale + skip-frame + history stacking) that turns a
pixel env into a (history, h, w) tensor observation (SURVEY.md §2.7).

The n-step TD update is one step of the learner's own Adam (as the
reference writes it: ``t = it + 1``, a constant learning rate, ``eps``
outside the square root, ``beta^t`` in float32), not the library's
updater.  As in the reference's code, a worker acts and bootstraps from
the snapshots it took before its rollout and computes its update under
the lock from the parameters current then; the target syncs every
``targetDqnUpdateFreq`` updates.  The networks live on the learner's
device (``cuda`` unless given).

HistoryProcessor crops, then rescales on its device: an area average for
integer factors, else the linear resize of ``jax.image.resize``, which
antialiases when it shrinks (``F.interpolate(..., antialias=True)``
computes the same triangle filter); the frames it keeps are host arrays.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.learning.schedules import _f32pow
from deeplearning4j_tpu_torch.rl.a3c import (_carry, _init_mlp, _map, _mlp,
                                             _value_and_grad, _zip_map)
from deeplearning4j_tpu_torch.rl.mdp import (MDP, DiscreteSpace,
                                             ObservationSpace, StepReply)
from deeplearning4j_tpu_torch.rl.qlearning import EpsGreedy

__all__ = ["AsyncQLearningConfiguration", "AsyncNStepQLearningDiscrete",
           "HistoryProcessor", "HistoryProcessorConfiguration",
           "HistoryMDP", "PixelCartPole"]


@dataclasses.dataclass
class AsyncQLearningConfiguration:
    """Reference: AsyncQLearningConfiguration fields."""
    seed: int = 123
    maxEpochStep: int = 200
    maxStep: int = 20000
    numThread: int = 4
    nstep: int = 5
    gamma: float = 0.99
    learningRate: float = 1e-3
    minEpsilon: float = 0.05
    epsilonNbStep: int = 5000
    targetDqnUpdateFreq: int = 100   # updates between target syncs


def _td_loss(params, obs, acts, targets):
    q = _mlp(params, obs)                                  # (b, nOut)
    qa = torch.gather(q, 1, acts[:, None])[:, 0]
    return torch.mean((qa - targets) ** 2)


class AsyncNStepQLearningDiscrete:
    """Hogwild n-step Q-learning over a dense (or history-stacked,
    flattened) observation MDP, on ``device`` (``cuda`` unless given).
    ``params`` / ``target_params`` carry the reference's ``[{"W", "b"},
    ...]`` pytrees (the target defaults to a copy of ``params``)."""

    def __init__(self, mdp_factory, conf: Optional[
            AsyncQLearningConfiguration] = None, hidden=(64,), device=None,
            params=None, target_params=None):
        self.conf = conf or AsyncQLearningConfiguration()
        c = self.conf
        self.device = resolve_device(device)
        self.mdps: List[MDP] = [mdp_factory(i) for i in range(c.numThread)]
        shape = self.mdps[0].getObservationSpace().shape
        self.nIn = int(np.prod(shape))
        self.nOut = self.mdps[0].getActionSpace().getSize()
        if params is not None:
            self.params = _carry(params, self.device)
        else:
            self.params = _init_mlp(torch.Generator().manual_seed(c.seed),
                                    (self.nIn,) + tuple(hidden)
                                    + (self.nOut,), self.device)
        # the target is a copy in storage of its own: no update of the
        # online net can move it between syncs
        if target_params is not None:
            self.target_params = _carry(target_params, self.device)
        else:
            self.target_params = _map(torch.clone, self.params)
        self._optState = _map(lambda a: {"m": torch.zeros_like(a),
                                         "v": torch.zeros_like(a)},
                              self.params)
        self.stepCount = 0
        self._updates = 0

    # ------------------------------------------------------------------
    def _update(self, params, opt, obs, acts, targets, it):
        """One step of the learner's Adam on the n-step TD loss:
        ``(new params, new state, loss)``; ``params`` are not touched."""
        lr = self.conf.learningRate
        b1, b2, eps = 0.9, 0.999, 1e-8
        t = float(it) + 1.0
        c1, c2 = 1 - _f32pow(b1, t), 1 - _f32pow(b2, t)
        loss, grads = _value_and_grad(_td_loss, params, obs, acts, targets)
        g = iter(grads)

        def leaf(p, st):
            gg = next(g)
            m = b1 * st["m"] + (1 - b1) * gg
            v = b2 * st["v"] + (1 - b2) * gg * gg
            mh = m / c1
            vh = v / c2
            return p - lr * mh / (torch.sqrt(vh) + eps), {"m": m, "v": v}
        with torch.no_grad():
            newp, news = _zip_map(leaf, params, opt)
        return newp, news, loss

    def _qvals(self, params, obs: np.ndarray) -> np.ndarray:
        """Q-values of host observations (b, nIn), back on the host."""
        with torch.no_grad():
            return _mlp(params, torch.as_tensor(obs, device=self.device)) \
                .cpu().numpy()

    # ------------------------------------------------------------------
    def train(self) -> None:
        c = self.conf
        lock = threading.Lock()
        eps = EpsGreedy(c.minEpsilon, c.epsilonNbStep, seed=c.seed)
        dev = self.device

        def worker(widx: int):
            env = self.mdps[widx]
            rng = np.random.RandomState(c.seed + 1000 * widx)
            obs = np.asarray(env.reset(), np.float32).ravel()
            ep_steps = 0
            while True:
                with lock:
                    if self.stepCount >= c.maxStep:
                        return
                    params = self.params          # stale Hogwild snapshot
                    tparams = self.target_params
                    step_now = self.stepCount
                o_l, a_l, r_l = [], [], []
                done = False
                for _ in range(c.nstep):
                    q = self._qvals(params, obs[None])[0]
                    if rng.rand() < eps.epsilon(step_now + len(o_l)):
                        a = int(rng.randint(self.nOut))
                    else:
                        a = int(np.argmax(q))
                    reply = env.step(a)
                    o_l.append(obs)
                    a_l.append(a)
                    r_l.append(float(reply.getReward()))
                    obs = np.asarray(reply.getObservation(),
                                     np.float32).ravel()
                    ep_steps += 1
                    if reply.isDone() or ep_steps >= c.maxEpochStep:
                        done = True
                        break
                if done:
                    R = 0.0
                else:
                    # bootstrap from the TARGET network (rl4j semantics)
                    R = float(np.max(self._qvals(tparams, obs[None])[0]))
                targets = []
                for rr in reversed(r_l):
                    R = rr + c.gamma * R
                    targets.append(R)
                targets.reverse()
                with lock:
                    self.params, self._optState, _ = self._update(
                        self.params, self._optState,
                        torch.as_tensor(np.stack(o_l), device=dev),
                        torch.as_tensor(np.asarray(a_l, np.int64),
                                        device=dev),
                        torch.as_tensor(np.asarray(targets, np.float32),
                                        device=dev),
                        self._updates)
                    self._updates += 1
                    self.stepCount += len(o_l)
                    if self._updates % c.targetDqnUpdateFreq == 0:
                        self.target_params = _map(torch.clone, self.params)
                if done:
                    obs = np.asarray(env.reset(), np.float32).ravel()
                    ep_steps = 0

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(len(self.mdps))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # ------------------------------------------------------------------
    def qValues(self, obs) -> np.ndarray:
        return self._qvals(self.params,
                           np.asarray(obs, np.float32).ravel()[None])[0]

    def play(self, env: MDP, max_steps: int = 500) -> float:
        """Greedy rollout; returns the episode reward."""
        obs = np.asarray(env.reset(), np.float32).ravel()
        total = 0.0
        for _ in range(max_steps):
            a = int(np.argmax(self.qValues(obs)))
            reply = env.step(a)
            total += float(reply.getReward())
            obs = np.asarray(reply.getObservation(), np.float32).ravel()
            if reply.isDone():
                break
        return total


# ---------------------------------------------------------------------------
# HistoryProcessor — the Atari-class image pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HistoryProcessorConfiguration:
    """Reference: HistoryProcessor.Configuration (historyLength,
    rescaledWidth/Height, cropping, skipFrame)."""
    historyLength: int = 4
    rescaledWidth: int = 16
    rescaledHeight: int = 16
    croppingWidth: int = 0      # 0 = no crop
    croppingHeight: int = 0
    offsetX: int = 0
    offsetY: int = 0
    skipFrame: int = 2


class HistoryProcessor:
    """Grayscale-downscale + skip-frame + stack (reference semantics:
    ``record`` every frame, ``add`` every skipFrame-th; ``getHistory``
    is the (historyLength, h, w) observation).  Frames are scaled on
    ``device`` (``cuda`` unless given)."""

    def __init__(self, conf: Optional[HistoryProcessorConfiguration] = None,
                 device=None):
        self.conf = conf or HistoryProcessorConfiguration()
        self.device = resolve_device(device)
        self._frames: deque = deque(maxlen=self.conf.historyLength)
        self._recorded = 0

    def _scale(self, img) -> torch.Tensor:
        """One raw frame, grayscale, cropped and rescaled, on the device."""
        c = self.conf
        x = torch.as_tensor(np.asarray(img), device=self.device) \
            .to(torch.float32)
        if x.ndim == 3:                      # (h, w, c) -> grayscale
            x = torch.mean(x, dim=-1)
        if c.croppingWidth and c.croppingHeight:
            x = x[c.offsetY:c.offsetY + c.croppingHeight,
                  c.offsetX:c.offsetX + c.croppingWidth]
        h, w = x.shape
        if h % c.rescaledHeight == 0 and w % c.rescaledWidth == 0:
            fh, fw = h // c.rescaledHeight, w // c.rescaledWidth
            return x.reshape(c.rescaledHeight, fh, c.rescaledWidth,
                             fw).mean(dim=(1, 3))
        return F.interpolate(x[None, None],
                             size=(c.rescaledHeight, c.rescaledWidth),
                             mode="bilinear", align_corners=False,
                             antialias=True)[0, 0]

    def _frame(self, img) -> np.ndarray:
        return self._scale(img).cpu().numpy()

    def record(self, frame) -> bool:
        """Feed one raw frame; returns True when it entered the history
        (every ``skipFrame``-th frame, reference convention)."""
        take = self._recorded % max(self.conf.skipFrame, 1) == 0
        self._recorded += 1
        if take:
            self._frames.append(self._frame(frame))
        return take

    def startEpisode(self, frame) -> None:
        """Reset history to `historyLength` copies of the first frame."""
        self._frames.clear()
        self._recorded = 0
        f = self._frame(frame)
        for _ in range(self.conf.historyLength):
            self._frames.append(f)
        self._recorded = 1

    def getHistory(self) -> np.ndarray:
        return np.stack(self._frames)            # (len, h, w)


class HistoryMDP(MDP):
    """Wrap a pixel-observation MDP with a HistoryProcessor (on ``device``):
    observations become (historyLength, h, w) stacks; env steps during
    skipped frames repeat the chosen action (reference skip-frame
    semantics)."""

    def __init__(self, inner: MDP,
                 conf: Optional[HistoryProcessorConfiguration] = None,
                 device=None):
        self.inner = inner
        self.hp = HistoryProcessor(conf, device)
        c = self.hp.conf
        self._space = ObservationSpace(
            (c.historyLength, c.rescaledHeight, c.rescaledWidth))

    def getObservationSpace(self):
        return self._space

    def getActionSpace(self):
        return self.inner.getActionSpace()

    def reset(self):
        self.hp.startEpisode(self.inner.reset())
        return self.hp.getHistory()

    def step(self, action) -> StepReply:
        c = self.hp.conf
        total = 0.0
        done = False
        for _ in range(max(c.skipFrame, 1)):
            reply = self.inner.step(action)
            total += float(reply.getReward())
            frame = reply.getObservation()
            done = reply.isDone()
            if done:
                break
        self.hp._frames.append(self.hp._frame(frame))
        return StepReply(self.hp.getHistory(), total, done)

    def isDone(self):
        return self.inner.isDone()


class PixelCartPole(MDP):
    """CartPole rendered as a synthetic grayscale image on the host — the
    Atari-shaped stand-in used to exercise the HistoryProcessor pipeline
    offline (reference tests use ALE; no ROMs in this image).  The
    reference's pixels, with the pole drawn by array ops (its per-pixel
    Python loop bounded the whole pipeline on the card)."""

    def __init__(self, seed: int = 0, size: Tuple[int, int] = (32, 32)):
        from deeplearning4j_tpu_torch.rl.mdp import CartPole
        self.inner = CartPole(seed=seed)
        self.h, self.w = size

    def getObservationSpace(self):
        return ObservationSpace((self.h, self.w))

    def getActionSpace(self) -> DiscreteSpace:
        return self.inner.getActionSpace()

    def _render(self, state) -> np.ndarray:
        x, _xdot, theta, _thdot = [float(v) for v in np.asarray(state)]
        img = np.zeros((self.h, self.w), np.float32)
        cx = int(np.clip((x / 2.4 + 1.0) / 2.0 * (self.w - 1), 0,
                         self.w - 1))
        base = self.h - 4
        img[base:base + 3, max(cx - 2, 0):cx + 3] = 1.0   # cart
        # pole: line from cart at angle theta (the reference's loop over
        # i, one array op: the same float64 products, truncated alike)
        i = np.arange(self.h // 2)
        px = np.clip(cx + np.sin(theta) * i, 0, self.w - 1).astype(np.int64)
        py = np.clip(base - np.cos(theta) * i, 0,
                     self.h - 1).astype(np.int64)
        img[py, px] = 0.7
        return img

    def reset(self):
        return self._render(self.inner.reset())

    def step(self, action) -> StepReply:
        reply = self.inner.step(action)
        return StepReply(self._render(reply.getObservation()),
                         reply.getReward(), reply.isDone())

    def isDone(self):
        return self.inner.isDone()
