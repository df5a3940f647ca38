"""Host launch calls per completed batch: every kernel or graph launch the
profiler saw the host make (cudaLaunchKernel*, cuLaunchKernel*,
cudaGraphLaunch) in the traced batches, over their count."""


def read(ctx: dict):
    if not ctx["batches"] or not ctx["trace"]["launch_calls"]:
        return None
    return ctx["trace"]["launch_calls"] / ctx["batches"]
