"""Seconds from the start of the process to the start of the window:
imports, the world and the weights from the seed, the store's
embeddings, the system's assembly, the kernels' build or load, and the
warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
