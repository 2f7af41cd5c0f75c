"""Device operations (kernels, copies, sets) in the traced window per reverse step."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not ctx.get("reverse_steps"):
        return None
    return t["device_ops"] / ctx["reverse_steps"]
