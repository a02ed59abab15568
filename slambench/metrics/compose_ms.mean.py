"""Mean time of a merged-map compose in the window (span `online.compose`,
which ends in a device sync)."""
UNIT = "ms"
LAYER = "session"
MOVES = "frame_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_mean_ms("online.compose")
