"""Mean time of a PCM pass over the inter-robot candidates in the window
(span `online.pcm`; its consistency matrices come to the host)."""
UNIT = "ms"
LAYER = "back end"
MOVES = "fleet_frames_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_mean_ms("online.pcm")
