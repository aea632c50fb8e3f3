"""Device ms a call of the replay kernels that the eager forward launched
inside the span ``int.dwconv``: the depthwise convs' route, its epilogue
included (``portbench/spans.py``). None where no kernel ran there (a
program without the route)."""

from portbench import spans


def read(run):
    return spans.engine_label_ms(run, "int.dwconv") or None
