from .grid import GridBasedPooling

__all__ = ["GridBasedPooling"]
