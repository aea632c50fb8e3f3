"""Images the engine returned over the window's wall time (host clock,
every call ending in a synchronize)."""


def read(run):
    w = run.window
    if w.get("kind") != "infer":
        return None
    return w["images"] / w["seconds"]
