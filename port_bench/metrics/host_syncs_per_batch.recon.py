"""Host-device synchronisations per traced batch: the `syncs` counter of the
root `batch` spans (every synchronisation torch.cuda's sync debug mode
reported while RohmPipeline.run_batch ran), summed over ctx["batches"]
(harness/spans.py)."""

from harness.spans import read as read_spans


def read(ctx: dict):
    tree = read_spans(ctx)
    if tree is None or any(r["syncs"] is None for r in tree["roots"]):
        return None
    return sum(r["syncs"] for r in tree["roots"]) / ctx["batches"]
