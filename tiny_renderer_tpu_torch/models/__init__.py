from .procedural import make_cube, make_plane, make_uv_sphere, to_geom

__all__ = ["make_cube", "make_plane", "make_uv_sphere", "to_geom"]
