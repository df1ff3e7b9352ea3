"""The train loop's wait for its next batch (the benchmark's ``loader``
span around the port's ``batch_iterator`` through ``_maybe_prefetch``:
gathering rows, loading pixels or features from disk), ms a step over the
window before the traced slice."""


def read(run):
    spans = run.spans.within("loader", *run.steady.ns)
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / len(spans) / 1e6
