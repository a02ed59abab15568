"""The VGICP accumulation kernel (`csrc/vgicp_accum.cu`, `accum_kernel`)
against its roofline in the profiled slice: its launches' operations and
bytes, each launch one verification chunk's GN step over the padded
chunk (`loopstage.CHUNK` candidates of `verify_capacity` points), over
the kernel's device time. The bytes count the per-point streams only, so
the share is a lower bound; the memory bound holds."""
UNIT = "%"
LAYER = "kernels"
MOVES = "fleet_frames_per_s"
SOURCE = "device_trace"

CHUNK = 8  # candidates a verification launch holds (the program's `loopstage.CHUNK`)


def read(ctx):
    launches, seconds = ctx.kernel("accum_kernel")
    if not launches or seconds <= 0.0:
        return None
    flops, nbytes = ctx.roofline.vgicp_launch(CHUNK, ctx.cfg.loops.verify_capacity)
    pct, _ = ctx.roofline.share(launches * flops, launches * nbytes, seconds)
    return pct
