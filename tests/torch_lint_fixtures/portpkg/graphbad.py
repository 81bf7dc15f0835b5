"""Planted GRAPH001-003 violations, reached from graph captures."""

import os
import random
import time

import numpy as np
import torch

from .models.capture import capture_step
from .obs.devtime import record_compile
from .utils.config import knob

_STEPS = 0


def _bump():
    global _STEPS                            # GRAPH002: global mutated
    _STEPS += 1


def _helper(x):
    t = time.time()                          # GRAPH001: clock read
    _bump()
    return x * t


def decode_step(state):
    scale = os.environ.get("SCALE", "1")     # GRAPH001: env read
    k = knob("LFKT_CACHE_DIR")               # GRAPH001: knob read
    noise = np.random.rand()                 # GRAPH001: host RNG
    print("step")                            # GRAPH001: print
    n = state["pos"].item()                  # GRAPH003: host sync
    state["out"][n] = _helper(state["token"]) + float(scale) + noise + len(k)


def audited_step(state):  # lfkt: noqa[GRAPH003] -- fixture: a def-line audit covers the body
    return state["pos"].tolist()


class Graphs:
    def __init__(self, state, stream):
        self.state = state
        self.stream = stream

    def _verify(self):
        torch.cuda.synchronize()             # GRAPH003: device sync
        audited_step(self.state)

    def capture(self):
        g = capture_step(lambda: decode_step(self.state), self.stream)
        record_compile("decode", "k", 0.0)
        return g

    def capture_verify(self):
        g = capture_step(self._verify, self.stream)
        record_compile("verify", "k", 0.0)
        return g

    def capture_inline(self):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self.state["pos"].cpu()          # GRAPH003: inline capture body
            random.random()                  # GRAPH001: inline capture body
        record_compile("inline", "k", 0.0)
        return g


def host_only(state):
    """The clean twin: the same sins, never captured."""
    t = time.time()
    print(os.environ.get("SCALE"), t, state["pos"].item())
    torch.cuda.synchronize()
