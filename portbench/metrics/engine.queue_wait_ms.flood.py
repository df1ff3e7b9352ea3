"""The gathered engine's queue: the mean wait of a request from its submit
to the dispatcher's claim (``stats()["queue_wait_s"]`` over
``stats()["claimed"]``) over the window before the traced slice, ms."""


def read(run):
    s0, s1 = run.steady.stats
    if "queue_wait_s" not in s0 or "claimed" not in s0:
        return None
    claimed = s1["claimed"] - s0["claimed"]
    if claimed <= 0:
        return None
    return 1e3 * (s1["queue_wait_s"] - s0["queue_wait_s"]) / claimed
