"""Planted PIN001-002 violations over a graph's pinned buffers."""

import torch

from .models.capture import capture_step
from .obs.devtime import record_compile


def replay_step(graph, n):
    for _ in range(n):
        graph.replay()


class Graphs:
    _GRAPH_PINNED = ("_state", "_out", "_ghost")   # PIN001: _ghost never assigned

    def __init__(self, device):
        self._state = {"pos": torch.zeros(1, device=device)}
        self._out = torch.zeros(8, device=device)
        self._graph = None

    def capture(self):
        self._graph = capture_step(lambda: self._out.add_(1), None)
        record_compile("pin", "k", 0.0)

    def reset_bad(self, device):
        self._out = torch.zeros(8, device=device)  # PIN001: rebinds a pinned buffer

    def reset_good(self):
        self._out.zero_()                    # fine: refilled in place
        self._state["pos"].fill_(0)

    def chunk(self, n):
        replay_step(self._graph, n)
        return self._out

    def stale(self):
        self.chunk(1)
        first = self._out[:4]                # a view of this replay's output
        self.chunk(1)                        # a later replay overwrites it
        return first.sum()                   # PIN002: read after the replay

    def fresh(self):
        self.chunk(1)
        first = self._out[:4].clone()        # fine: copied before the replay
        self.chunk(1)
        return first.sum()

    def one_replay(self):
        self.chunk(1)
        view = self._out[:4]                 # fine: no replay after the view
        return view.sum()


class Engine:
    _GRAPH_PINNED = ("_ring",)

    def __init__(self, device):
        self._ring = torch.zeros(4, device=device)

    def recover(self, device):
        self._ring = torch.zeros(4, device=device)  # PIN001: a new ring no replay sees

    def recover_in_place(self):
        self._ring.zero_()                   # fine
