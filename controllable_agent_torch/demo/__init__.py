from .core import DemoEngine
