"""setup.kernels_s: seconds of set-up spent loading the port's CUDA kernel
libraries and its native BVH builder, building each where the checkout has
no build yet (host clock)."""


def read(ctx):
    return ctx.kernels_s
