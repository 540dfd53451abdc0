"""R22 fixture: metric-name registry conformance.

Positive cases: ``bad_typo`` misspells a declared perf histogram,
``bad_adhoc`` invents an undeclared family, ``bad_category`` /
``bad_interval`` misspell goodput ledger categories.  Clean twins:
declared names in ``good``, a variable-valued name (dynamic, skipped),
and an unrelated object's own ``.observe()`` method.
"""

from ray_tpu_torch.observability import goodput, perf


def bad_typo(ms):
    perf.observe("task.exeucte", ms)


def bad_adhoc(ms):
    perf.observe("myfeature.latency", ms)


def bad_category(s):
    goodput.account("checkpoint_stall", s)


def bad_interval():
    with goodput.interval("compile_wait"):
        pass


def good(ms, s, name):
    perf.observe("task.execute", ms)
    goodput.account("ckpt_stall", s)
    with goodput.interval("data_wait"):
        pass
    perf.observe(name, ms)  # dynamic: statically unverifiable, skipped


class _OwnHistogram:
    def observe(self, value):
        self.value = value


def good_other(h, v):
    h.observe(v)  # not the perf plane: out of scope
