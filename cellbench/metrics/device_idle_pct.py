"""Share of the traced window in which no operation ran on the card, in
percent: 100 (1 - busy / window) from the device trace."""


def read(ctx):
    if not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
