"""Mean time of a solve's preparation in the window (span
`online.solve.prepare`: the graph with the accepted loops, the anchors,
the scatter plan's host read and the runner's lookup, up to the first
replay)."""
UNIT = "ms"
LAYER = "back end"
MOVES = "fleet_frames_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_mean_ms("online.solve.prepare")
