"""Advantage actor-critic (the reference's A3C family) — the port of
``deeplearning4j_tpu/rl/a3c.py``.

Reference: rl4j-core ``org/deeplearning4j/rl4j/learning/async/a3c/discrete/
A3CDiscreteDense.java`` + ``ActorCriticFactorySeparateStdDense`` and the
async gradient-accumulating worker threads.

``A3CDiscreteDense`` steps all ``numThread`` environments in lockstep (one
batched logits call per tick), accumulates n-step rollouts, then makes one
update of the combined actor-critic loss (policy gradient with advantage +
value MSE + entropy bonus) through the library's Adam, leaf by leaf.
``A3CDiscreteDenseAsync`` runs one worker thread per environment.

The networks are plain lists of ``{"W", "b"}`` tensors on the learner's
device (``cuda`` unless given), drawn from a host ``torch.Generator`` seeded
with the configuration's seed, or carried from the reference's pytree
(``params=``, numpy arrays).  The action draws keep the reference's host
``RandomState`` streams.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.learning.config import Adam
from deeplearning4j_tpu_torch.models.multilayer import _to_tensor
from deeplearning4j_tpu_torch.rl.mdp import MDP
from deeplearning4j_tpu_torch.rl.policy import Policy, softmax_sample


@dataclasses.dataclass
class A3CConfiguration:
    """Reference: A3CLearningConfiguration fields (nstep etc.)."""
    seed: int = 123
    maxEpochStep: int = 200
    maxStep: int = 20000
    numThread: int = 4          # becomes the rollout batch width
    nstep: int = 8
    gamma: float = 0.99
    learningRate: float = 7e-4
    entropyCoef: float = 0.01
    valueCoef: float = 0.5


def _init_mlp(gen: torch.Generator, sizes, device, dtype=torch.float32):
    """Layers of ``{"W": N(0, 2/(a+b)), "b": 0}``, drawn on the host from
    ``gen`` (the same values on every device)."""
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        s = (2.0 / (a + b)) ** 0.5
        params.append({"W": (torch.randn((a, b), generator=gen, dtype=dtype)
                             * s).to(device),
                       "b": torch.zeros((b,), dtype=dtype, device=device)})
    return params


def _mlp(params, x):
    for i, p in enumerate(params):
        x = x @ p["W"] + p["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def _carry(tree, device):
    """The reference's parameter pytree (dicts and lists of arrays, as
    numpy or tensors) as tensors on ``device``: the carry path of
    ``MultiLayerNetwork.init(params=)`` for the plain MLPs."""
    if isinstance(tree, dict):
        return {k: _carry(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_carry(v, device) for v in tree]
    return _to_tensor(tree, device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _zip_map(fn, params, opt):
    """``fn(param, its state)`` over a parameter tree and its optimizer
    tree (a state dict where the parameters have a tensor), in leaf order;
    returns the new parameter tree and the new optimizer tree."""
    if isinstance(params, dict):
        out = {k: _zip_map(fn, params[k], opt[k]) for k in params}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    if isinstance(params, list):
        out = [_zip_map(fn, p, s) for p, s in zip(params, opt)]
        return [o[0] for o in out], [o[1] for o in out]
    return fn(params, opt)


def _value_and_grad(loss_fn, params, *args):
    """``loss_fn(params, *args)`` and its gradient, leaf by leaf in
    ``_leaves`` order; ``params`` are not touched."""
    live = _map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(live, *args)
    return loss.detach(), list(torch.autograd.grad(loss, _leaves(live)))


class ActorCriticSeparate:
    """Separate policy/value MLPs (reference:
    ActorCriticFactorySeparateStdDense) on ``device`` (``cuda`` unless
    given): drawn from ``seed`` or carried from ``params`` (the
    reference's ``{"actor": [...], "critic": [...]}`` pytree)."""

    def __init__(self, nIn: int, nOut: int, seed: int = 0, hidden=(64,),
                 device=None, params=None):
        self.device = resolve_device(device)
        if params is not None:
            self.params = _carry(params, self.device)
        else:
            gen = torch.Generator().manual_seed(seed)
            self.params = {
                "actor": _init_mlp(gen, (nIn, *hidden, nOut), self.device),
                "critic": _init_mlp(gen, (nIn, *hidden, 1), self.device),
            }

    @staticmethod
    def logits(params, obs):
        return _mlp(params["actor"], obs)

    @staticmethod
    def value(params, obs):
        return _mlp(params["critic"], obs)[..., 0]

    def _host(self, fn, params, obs) -> np.ndarray:
        """``fn(params, obs)`` for host observations, back on the host."""
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32),
                                device=self.device)
            return fn(params, x).cpu().numpy()


class ACPolicy(Policy):
    """Sample (or argmax) from the learned policy (reference:
    policy/ACPolicy.java)."""

    def __init__(self, net: ActorCriticSeparate, seed: int = 0,
                 greedy: bool = False):
        self.net = net
        self.greedy = greedy
        self._rng = np.random.RandomState(seed)

    def nextAction(self, obs) -> int:
        logits = self.net._host(ActorCriticSeparate.logits, self.net.params,
                                np.asarray(obs, np.float32)[None])[0]
        if self.greedy:
            return int(np.argmax(logits))
        return softmax_sample(self._rng, logits)


class A3CDiscreteDense:
    """Reference: A3CDiscreteDense — here a synchronous batched A2C on
    ``device`` (``cuda`` unless given); ``params`` carries the reference's
    actor-critic pytree."""

    def __init__(self, mdp: MDP, conf: Optional[A3CConfiguration] = None,
                 hidden=(64,), device=None, params=None):
        self.conf = conf or A3CConfiguration()
        self.mdps: List[MDP] = [mdp] + [
            mdp.newInstance() for _ in range(self.conf.numThread - 1)]
        nIn = int(np.prod(mdp.getObservationSpace().shape))
        self.nOut = mdp.getActionSpace().getSize()
        self.net = ActorCriticSeparate(nIn, self.nOut, self.conf.seed, hidden,
                                       device, params)
        self._rng = np.random.RandomState(self.conf.seed)
        self.stepCount = 0
        self._updater = Adam(self.conf.learningRate)
        self._optState = _map(self._updater.init, self.net.params)
        self._obs = [m.reset() for m in self.mdps]
        self._ep_steps = [0] * len(self.mdps)

    def _loss(self, params, obs, acts, returns):
        c = self.conf
        logits = ActorCriticSeparate.logits(params, obs)
        values = ActorCriticSeparate.value(params, obs)
        logp = torch.log_softmax(logits, dim=-1)
        chosen = torch.gather(logp, 1, acts[:, None])[:, 0]
        adv = returns - values
        policy_loss = -(chosen * adv.detach()).mean()
        value_loss = (adv ** 2).mean()
        entropy = -(torch.exp(logp) * logp).sum(-1).mean()
        return policy_loss + c.valueCoef * value_loss \
            - c.entropyCoef * entropy

    def _update(self, params, optState, obs, acts, returns, it):
        """One Adam step of the actor-critic loss on (obs, acts, returns)
        from ``params``: ``(new params, new optimizer state, loss)``."""
        up = self._updater
        loss, grads = _value_and_grad(self._loss, params, obs, acts, returns)
        lr = up.currentLr(it, 0)
        g = iter(grads)

        def step_leaf(p, st):
            upd, st2 = up.apply(next(g), st, lr, it, 0, param=p)
            return p - upd, st2
        with torch.no_grad():
            new_p, new_s = _zip_map(step_leaf, params, optState)
        return new_p, new_s, loss

    def _batch(self, obs, acts, returns):
        """Host rollout lists as the update's tensors on the device."""
        dev = self.net.device
        return (torch.as_tensor(np.stack(obs).astype(np.float32), device=dev),
                torch.as_tensor(np.asarray(acts, np.int64), device=dev),
                torch.as_tensor(np.asarray(returns, np.float32), device=dev))

    def _batched_logits(self, obs_batch: np.ndarray) -> np.ndarray:
        return self.net._host(ActorCriticSeparate.logits, self.net.params,
                              obs_batch)

    def train(self) -> None:
        c = self.conf
        W = len(self.mdps)
        it = 0
        while self.stepCount < c.maxStep:
            # lockstep rollout: ONE batched logits call per tick for all envs
            traj = [([], [], []) for _ in range(W)]   # obs, act, rew
            done_flags = [False] * W
            for _t in range(c.nstep):
                obs_batch = np.stack(self._obs)
                logits = self._batched_logits(obs_batch)
                for i, env in enumerate(self.mdps):
                    if done_flags[i]:
                        continue
                    a = softmax_sample(self._rng, logits[i])
                    reply = env.step(a)
                    traj[i][0].append(self._obs[i])
                    traj[i][1].append(a)
                    traj[i][2].append(reply.getReward())
                    self._obs[i] = reply.getObservation()
                    self._ep_steps[i] += 1
                    self.stepCount += 1
                    # reference semantics: truncate at maxEpochStep
                    if reply.isDone() or self._ep_steps[i] >= c.maxEpochStep:
                        self._obs[i] = env.reset()
                        self._ep_steps[i] = 0
                        done_flags[i] = True

            # bootstrap values for unfinished rollouts in ONE batched call
            boot_vals = self.net._host(ActorCriticSeparate.value,
                                       self.net.params, np.stack(self._obs))
            obs_b, act_b, ret_b = [], [], []
            for i in range(W):
                o, a, r = traj[i]
                if not o:
                    continue
                R = 0.0 if done_flags[i] else float(boot_vals[i])
                for oo, aa, rr in zip(reversed(o), reversed(a), reversed(r)):
                    R = rr + c.gamma * R
                    obs_b.append(oo)
                    act_b.append(aa)
                    ret_b.append(R)
            self.net.params, self._optState, _ = self._update(
                self.net.params, self._optState,
                *self._batch(obs_b, act_b, ret_b), it)
            it += 1

    def getPolicy(self, greedy: bool = True) -> ACPolicy:
        return ACPolicy(self.net, self.conf.seed, greedy=greedy)


class A3CDiscreteDenseAsync(A3CDiscreteDense):
    """True asynchronous A3C: one Python worker thread per environment,
    Hogwild-style updates against the shared parameters.

    Reference: rl4j ``A3CDiscrete`` / ``AsyncLearning`` — worker threads
    roll out against a stale copy of the global network and apply their
    n-step gradients asynchronously (SURVEY.md §2.7).

    As in the reference's code: a worker's actions and bootstrap value
    come from the snapshot it took before its rollout, while its update
    (gradient and step) is computed under the lock from the parameters
    current at that moment.  With ``numThread=1`` the run is
    deterministic.  The batched ``A3CDiscreteDense`` stays the default
    for its reproducible updates.
    """

    def train(self) -> None:
        import threading
        c = self.conf
        lock = threading.Lock()     # serializes the shared-param update
        self._updates = 0           # optimizer iteration (NOT env steps:
        # Adam bias correction / LR schedules count updates, same as sync)

        def worker(widx: int):
            env = self.mdps[widx]
            rng = np.random.RandomState(c.seed + 1000 * widx)
            obs = env.reset()
            ep_steps = 0
            while True:
                with lock:
                    if self.stepCount >= c.maxStep:
                        return
                    params = self.net.params   # stale snapshot (Hogwild)
                o_l, a_l, r_l = [], [], []
                done = False
                for _ in range(c.nstep):
                    logits = self.net._host(ActorCriticSeparate.logits,
                                            params, obs[None])[0]
                    a = softmax_sample(rng, logits)
                    reply = env.step(a)
                    o_l.append(obs)
                    a_l.append(a)
                    r_l.append(reply.getReward())
                    obs = reply.getObservation()
                    ep_steps += 1
                    if reply.isDone() or ep_steps >= c.maxEpochStep:
                        obs = env.reset()
                        ep_steps = 0
                        done = True
                        break
                R = 0.0 if done else float(self.net._host(
                    ActorCriticSeparate.value, params, obs[None])[0])
                rets = []
                for rr in reversed(r_l):
                    R = rr + c.gamma * R
                    rets.append(R)
                rets.reverse()
                with lock:
                    # the update is computed from, and applied to, the
                    # CURRENT shared params (the reference's code)
                    self.net.params, self._optState, _ = self._update(
                        self.net.params, self._optState,
                        *self._batch(o_l, a_l, rets), self._updates)
                    self._updates += 1
                    self.stepCount += len(o_l)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(len(self.mdps))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
