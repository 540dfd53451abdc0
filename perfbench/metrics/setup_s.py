"""setup_s: seconds from the process's start to the first timed step or
request, the kernels' build and every warm-up included."""


def read(record):
    return record.get("setup_s")
