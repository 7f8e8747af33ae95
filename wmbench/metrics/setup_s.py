"""Seconds from the process's start to the window's: importing torch, the
card's context, loading (or, in a fresh checkout, building) the kernel
library, making the inputs and warming up (host clock)."""


def read(ctx):
    return ctx.setup_s
