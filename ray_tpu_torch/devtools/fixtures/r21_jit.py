"""R21 fixture: compile and capture stability, the PyTorch form.

Positive cases: ``loop_jit`` constructs a ``torch.compile`` callable
inside a loop, ``per_call`` / ``immediate`` construct-and-invoke per
call, and ``bad_donate`` writes a tensor in place after handing it to
``put`` (the counterpart of reading a donated buffer: ``get`` of that
ref raises).  ``bad_static`` / ``bad_shape`` / ``bad_decorated_call`` /
``bad_scalar`` keep the JAX fixture's shapes, which have no PyTorch
counterpart (no ``static_argnums``; ``torch.compile`` marks a changing
int dynamic instead of re-tracing per value) and stay quiet.  Clean
twins: the module-level ``_CACHED`` construct, ``Model.__init__``'s
attribute store, and ``Model.good``, which puts a clone and so may
write the original.
"""

import functools

import torch

import ray_tpu_torch


def _impl(state, k):
    return state


_CACHED = torch.compile(_impl)


def loop_jit(xs):
    out = []
    for x in xs:
        f = torch.compile(_impl)
        out.append(f(x, 1))
    return out


def per_call(x):
    f = torch.jit.script(_impl)
    return f(x, 1)


def immediate(x):
    return torch.compile(_impl)(x, 1)


@functools.partial(torch.compile, dynamic=False)
def decorated_step(state, k):
    return state


def bad_decorated_call(state):
    return decorated_step(state, {"a": 1})


class Model:
    def __init__(self):
        self._step = torch.compile(_impl, dynamic=False)

    def good(self, state):
        ref = ray_tpu_torch.put(state.clone())
        state.add_(4)
        return ref

    def bad_static(self, state):
        return self._step(state, [1, 2])

    def bad_shape(self, state, x):
        return self._step(state, x.shape)

    def bad_donate(self, state):
        ref = ray_tpu_torch.put(state)
        state.add_(4)
        return ref, state

    def bad_scalar(self, state, items):
        return self._step(state, len(items))

    def padded_scalar(self, state, items):
        items = items[:8]
        return self._step(state, len(items))
