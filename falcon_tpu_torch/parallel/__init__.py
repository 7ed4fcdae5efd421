from .mesh import (  # noqa: F401
    Mesh,
    all_gather,
    make_mesh,
    pmin,
    ppermute,
    psum,
    shard_rows,
)
