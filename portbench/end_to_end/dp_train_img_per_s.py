"""Global images trained over the window, on rank 0's clock between two
barriers, data-parallel over several cards."""


def read(run):
    w = run.window
    if w.get("kind") != "train" or w["ranks"] == 1:
        return None
    return w["images"] / w["seconds"]
