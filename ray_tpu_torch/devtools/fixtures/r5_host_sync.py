"""R5 fixture: host syncs reachable from compiled or captured code.

Positive cases: ``helper``'s ``float()`` reached from the
``torch.compile``-decorated ``step``, ``step``'s own ``.item()``,
``body``'s ``.cpu()`` (``body`` is handed to ``torch.compile``), and a
``torch.cuda.synchronize()`` inside a ``torch.cuda.graph`` capture.
Clean twins: the same reads in ``report``, which nothing compiled or
captured reaches.
"""

import torch


def helper(x):
    return float(x)


@torch.compile
def step(x):
    return helper(x) + x.item()


def body(x):
    return x.sum().cpu()


def build(graph, static):
    fast = torch.compile(body)
    with torch.cuda.graph(graph):
        out = static * 2
        torch.cuda.synchronize()
    return fast, out


def report(x):
    return float(x), x.item(), x.cpu()
