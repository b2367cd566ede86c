"""Seconds from the process's start to the end of the warm-up (host clock)."""


def read(ctx):
    return ctx["setup_s"]
