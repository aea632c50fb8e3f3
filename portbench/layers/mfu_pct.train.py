"""The training step's share of the card's published bf16 peak (989
TFLOP/s, H100 SXM dense) over the window: 3 x 2 x the forward's MACs
(layer shapes, groups honoured) x images / seconds."""

from portbench import readings, work


def read(run):
    w = run.window
    if w.get("kind") != "train" or w["ranks"] != 1:
        return None
    return readings.mfu_pct(run, readings.flops_per_image(run), work.PEAKS["bf16_flops"])
