"""The data-parallel step's share of the published bf16 peak of all its
cards (cards x 989 TFLOP/s, H100 SXM dense) over the window: 3 x 2 x the
forward's MACs x global images / seconds."""

from portbench import readings, work


def read(run):
    w = run.window
    if w.get("kind") != "train" or w["ranks"] == 1:
        return None
    return readings.mfu_pct(run, readings.flops_per_image(run), work.PEAKS["bf16_flops"],
                            cards=w["ranks"])
