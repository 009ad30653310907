"""Images of every gradient tick in the window's calls over their wall
time (host clock, the card synchronised at each call's end)."""


def read(ctx):
    return ctx.work / sum(ctx.call_s) if ctx.unit == "images" else None
