"""Device ms of the host-to-device and device-to-host copies per frame
(profiler trace): the upload and the fetch of the served result."""


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    return ctx.trace.copy_s() * 1e3 / ctx.frames
