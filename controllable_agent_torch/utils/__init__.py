from .device import resolve_device
from .steps import Stopwatch, crossed, frames_remaining

__all__ = ["Stopwatch", "crossed", "frames_remaining", "resolve_device"]
