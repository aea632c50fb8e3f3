"""Images trained over the window's wall time, on one card."""


def read(run):
    w = run.window
    if w.get("kind") != "train" or w["ranks"] != 1:
        return None
    return w["images"] / w["seconds"]
