"""Mean host time the step loop waits in the loader's next(), from the
harness's ``feed_wait`` spans around the call."""


def read(r):
    waits = r.spans.durations_ms("feed_wait") if r.spans is not None else []
    return sum(waits) / len(waits) if waits else None
