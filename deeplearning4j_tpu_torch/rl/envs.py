"""Malmo- and ViZDoom-shaped environment adapters — the port of
``deeplearning4j_tpu/rl/envs.py``, a copy of its host numpy.

Reference: rl4j ``rl4j-malmo`` (``MalmoEnv``/``MalmoActionSpace`` —
discrete STRING commands like "move 1", observations assembled by a
MalmoObservationSpace policy) and ``rl4j-doom`` (``VizdoomEnv`` —
screen-buffer pixel observations + a boolean button vector per action)
— SURVEY.md §2.7.  Neither platform exists in this image (both need a
game process), so like ``GymEnv`` these adapters wrap ANY object
speaking the platform's protocol; the tests drive protocol fakes, and a
real MalmoPython/vizdoom handle plugs in unchanged.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.rl.mdp import (MDP, DiscreteSpace,
                                             ObservationSpace, StepReply)

__all__ = ["MalmoEnv", "VizdoomEnv"]


class MalmoEnv(MDP):
    """Discrete string-command environment (Malmo protocol shape).

    ``agent`` must provide ``startMission()/getWorldState()`` and
    ``sendCommand(str)`` (the MalmoPython AgentHost surface); world
    states expose ``observations`` (a numeric vector), ``rewards`` and
    ``is_mission_running``.  ``actions`` is the reference
    MalmoActionSpace command list (e.g. ["movenorth 1", ...])."""

    def __init__(self, agent: Any, actions: Sequence[str],
                 obs_shape: Tuple[int, ...]):
        self.agent = agent
        self.actions: List[str] = list(actions)
        self._obs_space = ObservationSpace(tuple(obs_shape))
        self._act_space = DiscreteSpace(len(self.actions))
        self._done = True

    def getObservationSpace(self):
        return self._obs_space

    def getActionSpace(self):
        return self._act_space

    def _observe(self, state) -> np.ndarray:
        return np.asarray(state.observations, np.float32).reshape(
            self._obs_space.shape)

    def reset(self):
        self.agent.startMission()
        state = self.agent.getWorldState()
        self._done = not state.is_mission_running
        return self._observe(state)

    def step(self, action: int) -> StepReply:
        self.agent.sendCommand(self.actions[int(action)])
        state = self.agent.getWorldState()
        reward = float(sum(state.rewards))
        self._done = not state.is_mission_running
        return StepReply(self._observe(state), reward, self._done)

    def isDone(self) -> bool:
        return self._done


class VizdoomEnv(MDP):
    """Screen-buffer environment (ViZDoom protocol shape).

    ``game`` must provide ``new_episode()``, ``get_state()`` (with a
    ``screen_buffer`` ndarray), ``make_action(buttons) -> reward`` and
    ``is_episode_finished()`` (the vizdoom.DoomGame surface).  Actions
    are one-hot button vectors over ``num_buttons`` (the reference's
    convention); observations are the raw screen buffer — stack them
    with ``HistoryMDP`` for the Atari-class pipeline."""

    def __init__(self, game: Any, num_buttons: int,
                 screen_shape: Tuple[int, ...]):
        self.game = game
        self.num_buttons = int(num_buttons)
        self._obs_space = ObservationSpace(tuple(screen_shape))
        self._act_space = DiscreteSpace(self.num_buttons)
        self._blank = np.zeros(screen_shape, np.float32)
        self._done = True

    def getObservationSpace(self):
        return self._obs_space

    def getActionSpace(self):
        return self._act_space

    def _screen(self) -> np.ndarray:
        state = self.game.get_state()
        if state is None:                 # terminal state has no buffer
            return self._blank
        return np.asarray(state.screen_buffer, np.float32)

    def reset(self):
        self.game.new_episode()
        self._done = False
        return self._screen()

    def step(self, action: int) -> StepReply:
        buttons = [1 if i == int(action) else 0
                   for i in range(self.num_buttons)]
        reward = float(self.game.make_action(buttons))
        self._done = bool(self.game.is_episode_finished())
        return StepReply(self._screen(), reward, self._done)

    def isDone(self) -> bool:
        return self._done
