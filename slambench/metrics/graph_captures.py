"""CUDA graphs captured in the window (every `CUDAGraph.capture_begin` of
the process, counted by the benchmark): runner keys that were new in the
window, whose first call also ran eagerly."""
UNIT = "count"
LAYER = "graph runners"
MOVES = "fleet_frames_per_s"
SOURCE = "program_counter"


def read(ctx):
    return float(ctx.captures)
