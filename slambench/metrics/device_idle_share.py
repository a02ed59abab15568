"""The share of the profiled slice of the window in which no operation
ran on the device (the union of the device's operation intervals
against the slice's wall time; the profiler's host overhead stretches
the wall, so it is an upper bound)."""
UNIT = "%"
LAYER = "device"
MOVES = "fleet_frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    p = ctx.profile
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
