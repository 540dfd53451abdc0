"""train_tokens_per_s: the tokens of every step completed in the window
over the window's time; the window starts and ends with a synchronise."""


def read(record):
    if record.get("kind") != "train" or not record["window_s"]:
        return None
    return record["tokens"] / record["window_s"]
