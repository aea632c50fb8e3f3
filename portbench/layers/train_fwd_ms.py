"""Device ms a training step of the kernels launched inside the span
``train.forward``: the forward with its fake-quant chains and observers,
and the loss (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.train_span_ms(run, "train.forward")
