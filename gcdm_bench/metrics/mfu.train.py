"""The training window's model FLOPs (forward and backward, recomputation not counted, over real atoms,
by the benchmark's formula) over the measured window's time (the host clock, before the traced part)
and the precision's peak."""


def read(ctx):
    if not ctx.get("peak_flops") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / ctx["peak_flops"]
