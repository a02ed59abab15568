"""The share of the profiled slice in which the card idled while the host
was in the front-end: the idle gaps that fall to `online.frontend` or to
a span inside it (`online.frontend.project`, `online.frontend.gate_read`)
over the slice's wall time. The reduction keeps the largest idle-gap
entries only, so this sums those of them that are the front-end's."""
UNIT = "%"
LAYER = "front-end"
MOVES = "fleet_frames_per_s"
SOURCE = "device_trace"

SPAN = "online.frontend"


def read(ctx):
    p = ctx.profile
    if not p or not p["busy_s"] or not p["window_s"]:
        return None
    idle = sum(s for name, s in p["idle_gaps"] if name == SPAN or name.startswith(SPAN + "."))
    return 100.0 * idle / p["window_s"]
