"""The capture helper: its callers record each capture's compile."""

import torch


def capture_step(step, stream):
    step()                                  # the eager warm-up: same callable
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        step()
    return graph
