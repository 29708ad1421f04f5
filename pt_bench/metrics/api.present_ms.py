"""api.present_ms: the mean wall time of ``Renderer.image()`` a frame over
the window (host clock): the tonemap on the card and the copy of the uint8
image to the host."""


def read(ctx):
    return 1e3 * sum(ctx.presents) / len(ctx.presents) if ctx.presents else None
