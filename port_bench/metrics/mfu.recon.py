"""The whole batch's share of the card's peak, in %: the least time of the
nets' operations in the traced batches (PoseNet's products, attention and
embeddings, TrajNet's and TrajControl's convolutions, each precision class
over its published peak; harness/counts.py) over the traced window."""


def read(ctx: dict):
    window = ctx["trace"]["window_s"]
    if not ctx["batches"] or window <= 0:
        return None
    return 100.0 * ctx["least_batch_s"] * ctx["batches"] / window
