"""train_optimizer_ms: the mean of the program's ``train.optimizer``
histogram (a step's gradient norm and optimizer step, timed on the device
between two CUDA events on the step's stream) over the window."""

from perfbench.core.readers import perf_mean_ms


def read(record):
    if record.get("kind") != "train":
        return None
    return perf_mean_ms(record, "train.optimizer")
