"""Device ms a call of the replay kernels that the eager forward launched
inside the span ``int.epilogue``: the accumulator's cast and scale, the
bias, the requant to the next layer's codes, the adds' codes
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.engine_label_ms(run, "int.epilogue")
