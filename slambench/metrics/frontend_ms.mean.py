"""Mean time of a front-end tick in the window (span `online.frontend`:
the runner's odometry step and the keyframe gate, ending in the gate
bit's host read)."""
UNIT = "ms"
LAYER = "front-end"
MOVES = "fleet_frames_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_mean_ms("online.frontend")
