"""The gathered engine's resolver: its seconds in decode materialize (the
graph replays and the rows read back, ``stats()["decode_s"]``) over the
window before a traced run's profiler slice. Near 1, the decode sets the
pace; lower, the dispatcher's featurize and encode do."""


def read(run):
    s0, s1 = run.steady.stats
    if "decode_s" not in s0:
        return None
    return (s1["decode_s"] - s0["decode_s"]) / run.steady.seconds
