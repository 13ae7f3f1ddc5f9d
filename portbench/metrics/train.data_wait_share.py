"""train.data_wait_share: the share of the traced window's `fit` in which
its loop waited for the loader, in % (the sum of its epoch's `data_wait_s`
over its `time_s`, both the trainer's own counters)."""


def read(run):
    h = run.counters.get("history")
    if not h or not h.get("time_s"):
        return None
    return 100.0 * h["data_wait_s"] / h["time_s"]
