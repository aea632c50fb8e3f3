"""Host ms of one engine call (the span ``engine.call``: the copy in, the
graph's launch and the copy out, the card's work not waited for), the
median over ``spans.HOST_CALLS`` calls with the program's spans on and
no profiler (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_host_ms(run, "infer", "engine.call")
