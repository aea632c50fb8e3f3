"""Device ms a call of the replay kernels that the eager forward launched
inside the span ``int.quantize``: activation codes quantized from f32,
where a chain does not carry them (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.engine_label_ms(run, "int.quantize")
