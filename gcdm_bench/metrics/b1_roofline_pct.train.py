"""B1's share of its roofline over the training steps' forward calls: the least time its
work could take (FLOPs over real edge rows at the precision's peak, or its
bytes over the memory's) over the device time of the kernels launched
inside the message layer's forward entry."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("b1_s") or not ctx.get("b1_bound_s"):
        return None
    return 100.0 * ctx["b1_bound_s"] / t["b1_s"]
