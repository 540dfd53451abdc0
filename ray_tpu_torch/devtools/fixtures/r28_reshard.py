"""R28 fixture: implicit reshard across a local_map boundary.

Positive case: ``bad`` places a tensor replicated and then feeds a
``local_map(..., redistribute_inputs=True)`` callable whose
in_placements pin ``Shard(0)`` — DTensor inserts a silent redistribution
collective on every call.  The clean twin places with the consumer's
layout.  The JAX fixture's second case, a wasted buffer donation, has no
PyTorch counterpart (there is no donation); ``good_donate`` and
``bad_donate`` keep its shape as plain functions and stay quiet.
"""

import functools

from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

# placements below are per mesh dim of a one-dim mesh
_MESH = None


def _one(x):
    return x


_STEP = local_map(_one, out_placements=(Shard(0),),
                  in_placements=((Shard(0),),), redistribute_inputs=True)


def good(x, mesh):
    x = distribute_tensor(x, mesh, (Shard(0),))
    return _STEP(x)


def bad(x, mesh):
    x = distribute_tensor(x, mesh, (Replicate(),))
    return _STEP(x)


@functools.lru_cache(maxsize=None)
def _identity(n):
    return n


def good_donate(state, x):
    return state


@functools.lru_cache(maxsize=None)
def _identity_again(n):
    return n


def bad_donate(state, x):
    return state
