"""setup.scene_s: seconds of set-up spent on the scene: the configuration's
arrays generated, the port's ``Scene`` assembled, its tables built (or
loaded from the checkout's cache) and moved to the card (host clock)."""


def read(ctx):
    return ctx.scene_s
