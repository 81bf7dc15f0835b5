"""PERF001 (the port's form): a capture whose compile no one records."""

import torch

from .models.capture import capture_step


def unrecorded(step, stream):
    return capture_step(step, stream)        # PERF001: no record_compile


def unrecorded_inline():
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):                # PERF001: no record_compile
        pass
    return g
