"""Host waits on the card a window call: the window's increments of the
program's `sync.<site>` counters (each `.item()`, `.cpu()`, pageable
host-to-device copy, SVD and `torch.cuda.synchronize` of the session's
call tree) over the window's calls. Each wait drains the card's queue.
0 where no counter moved; nothing from a program without the counters,
which has no `online.frontend.gate_read` span either (every call reads
the keyframe gate in that span)."""
UNIT = "count"
LAYER = "device"
MOVES = "fleet_frames_per_s"
SOURCE = "program_counter"
MARK = "online.frontend.gate_read"


def read(ctx):
    if not ctx.calls_s or MARK not in ctx.spans:
        return None
    syncs = sum(v for k, v in ctx.counters.items() if k.startswith("sync."))
    return float(syncs) / len(ctx.calls_s)
