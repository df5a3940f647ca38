"""The host's launch calls inside the `guidance` spans per guided step: the
profiler's launch calls (cudaLaunchKernel*, cuLaunchKernel*,
cudaGraphLaunch; ctx["launch_ns"], their host start times) that fall in the
spans' host ranges, over the number of guided steps (harness/guided.py)."""

from harness.guided import launches_inside, read as read_guided


def read(ctx: dict):
    tree = read_guided(ctx)
    if tree is None or not ctx.get("launch_ns"):
        return None
    return launches_inside(ctx["launch_ns"], tree["guidance"]) / len(tree["guidance"])
