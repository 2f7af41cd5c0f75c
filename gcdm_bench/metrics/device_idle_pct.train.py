"""Share of the traced training window in which no device operation ran."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
