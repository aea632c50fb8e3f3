"""The 95th percentile (nearest rank) of every timed call's latency, from
its start on the host to its result."""

import math


def read(run):
    w = run.window
    if w.get("kind") != "infer":
        return None
    lat = sorted(w["latency_s"])
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
