"""Seconds from the first line of run.py to the first timed call."""


def read(ctx):
    return ctx.setup_s
