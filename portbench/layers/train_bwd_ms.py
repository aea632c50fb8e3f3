"""Device ms a training step of the kernels launched inside the span
``train.backward`` (autograd launches them from its own thread)
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.train_span_ms(run, "train.backward")
