"""Mean time of a chordal solve in the window (span `online.solve`, which
ends in a device sync)."""
UNIT = "ms"
LAYER = "back end"
MOVES = "fleet_frames_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_mean_ms("online.solve")
