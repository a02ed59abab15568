"""Mean time of one verification chunk in the window (span `loop.verify`,
one padded chunk of candidates, ending in the fitness read)."""
UNIT = "ms"
LAYER = "loop stage"
MOVES = "fleet_frames_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_mean_ms("loop.verify")
