from .device import resolve_device
from .steps import Stopwatch, crossed

__all__ = ["Stopwatch", "crossed", "resolve_device"]
