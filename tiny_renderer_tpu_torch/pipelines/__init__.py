"""Frame path and shaders of the torch port."""
