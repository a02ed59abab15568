"""Host seconds the window spent making CUDA-graph runners: every
runner kind's captures (`graph.<kind>.capture_s`) and eager first calls
(`graph.<kind>.eager_s`), the cost of a runner key new in the window.
0 where no counter moved; nothing from a program without the counters,
which has no `online.frontend.gate_read` span either (every call reads
the keyframe gate in that span)."""
UNIT = "s"
LAYER = "graph runners"
MOVES = "fleet_frames_per_s"
SOURCE = "program_counter"
MARK = "online.frontend.gate_read"


def read(ctx):
    if MARK not in ctx.spans:
        return None
    return float(sum(v for k, v in ctx.counters.items()
                     if k.startswith("graph.") and k.endswith((".capture_s", ".eager_s"))))
