"""GiB the allocator holds for the fit's captured graph (its private
pool's segments), read after the window."""


def read(ctx):
    pool = ctx.get("graph_pool_bytes")
    return None if pool is None else pool / 2**30
