"""B2's share of its roofline over the training steps: the least time the
message layer's backward could take (the gradients with respect to its
inputs and its weights: twice the forward's FLOPs over real edge rows, at
the precision's peak; or its bytes over the memory's) over the device time
of the kernels launched inside the message layer's autograd node, every
chunk included.  A recompute of the forward is the implementation's choice
and is not counted."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("b2_s") or not ctx.get("b2_bound_s"):
        return None
    return 100.0 * ctx["b2_bound_s"] / t["b2_s"]
