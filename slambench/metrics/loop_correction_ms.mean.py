"""Mean loop-correction latency of the window: for each loop that a solve
in the window kept for the first time, the host time from the later of
its two keyframes to the end of that solve (counters
`loops.correction_s` over `loops.corrected`)."""
UNIT = "ms"
LAYER = "back end"
MOVES = "fleet_frames_per_s"
SOURCE = "program_counter"


def read(ctx):
    n = ctx.counters.get("loops.corrected", 0.0)
    if not n:
        return None
    return 1e3 * ctx.counters.get("loops.correction_s", 0.0) / n
