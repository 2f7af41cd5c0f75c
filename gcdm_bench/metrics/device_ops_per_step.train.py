"""Device operations (kernels, copies, sets) in the traced window per optimizer step."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not ctx.get("optimizer_steps"):
        return None
    return t["device_ops"] / ctx["optimizer_steps"]
