"""train_report_ms: the mean of the program's ``train.report`` histogram
(``session.report``'s own cost) over the window."""

from perfbench.core.readers import perf_mean_ms


def read(record):
    if record.get("kind") != "train":
        return None
    return perf_mean_ms(record, "train.report")
