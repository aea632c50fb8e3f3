"""Device ms a training step of the kernels launched inside the span
``train.optimizer``: the zero fill of missing gradients and Adam's
per-parameter updates (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.train_span_ms(run, "train.optimizer")
