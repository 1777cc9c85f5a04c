"""Host frames yielded in the window over the window's seconds (host
clock), the stream's drain included."""


def read(ctx):
    return ctx.window.completed / ctx.window.seconds
