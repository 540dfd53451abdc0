"""serve_tokens_per_s: the real (unpadded) prompt tokens of the requests
due in the window that were answered, over the time from the window's
start to its close or to the last of those answers, whichever is later."""


def read(record):
    if record.get("kind") != "serve" or not record["window_s"]:
        return None
    return record["answered_tokens"] / record["window_s"]
