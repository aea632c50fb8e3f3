"""The engine's share of the card's published int8 peak (1,979 TOP/s,
H100 SXM dense) over the window: 2 x the forward's MACs (layer shapes,
groups honoured) x images / seconds."""

from portbench import readings, work


def read(run):
    if run.window.get("kind") != "infer":
        return None
    return readings.mfu_pct(run, readings.flops_per_image(run), work.PEAKS["int8_ops"])
