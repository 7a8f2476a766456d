"""One-pass graph algorithms."""

from .triangles import window_triangles

__all__ = ["window_triangles"]
