"""Device ms a call of the replay kernels that the eager forward launched
inside the span ``int.im2col``: the patch matrices, their padding and
the channel shuffles (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.engine_label_ms(run, "int.im2col")
