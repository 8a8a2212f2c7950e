from .sharding import (
    Mesh,
    make_pp_mesh,
    make_row_mesh,
    render_batch_sharded,
    render_frame_sharded,
    render_sequence_pipelined,
)

__all__ = [
    "Mesh",
    "make_pp_mesh",
    "make_row_mesh",
    "render_batch_sharded",
    "render_frame_sharded",
    "render_sequence_pipelined",
]
