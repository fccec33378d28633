"""server.temporal_ms: median latency (ms) of the window's temporal frames,
which refine the previous maps on the keyframe's forests. A stateful mix
only."""

from portbench.yardstick import median


def read(run):
    if not run.mix["stateful"]:
        return None
    lat = [f["latency_s"] for f in run.frames if not f["is_key"]]
    return median(lat) * 1e3 if lat else None
