"""Seconds a round spends writing the masks back to the store, from the
program's ``Stopwatch`` phase ``store_sync``."""


def read(run):
    sw = run.extra.get("stopwatch")
    if sw is None or not sw.counts["store_sync"]:
        return None
    return sw.times["store_sync"] / sw.counts["store_sync"]
