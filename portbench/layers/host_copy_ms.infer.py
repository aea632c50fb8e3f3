"""Host ms of one engine call's copies (the spans ``engine.copy_in``, the
input's copy into the bucket and its zero tail, and ``engine.copy_out``,
the output's clone), the median over ``spans.HOST_CALLS`` calls with the
program's spans on and no profiler (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_host_ms(run, "infer", "copy")
