"""Host ms of one training step on one card (the spans ``train.augment``
and ``train.step``, started on an idle card so that no full launch queue
holds the host back), the median over ``spans.HOST_STEPS`` steps with
the program's spans on and no profiler
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_host_ms(run, "train", "step")
