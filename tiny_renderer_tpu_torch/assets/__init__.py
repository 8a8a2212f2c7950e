from .model import Model, load_model
from .obj import parse_obj
from .tga import decode_tga, read_tga

__all__ = ["Model", "load_model", "parse_obj", "decode_tga", "read_tga"]
