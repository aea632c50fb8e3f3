"""Host ms of one engine call's replay (the span ``engine.replay``: the
CUDA graph's launch, the card's work not waited for), the median over
``spans.HOST_CALLS`` calls with the program's spans on and no profiler
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_host_ms(run, "infer", "engine.replay")
