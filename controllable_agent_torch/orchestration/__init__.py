from .executor import DelayedExecutor, LocalExecutor, wait_for_jobs
from .runner import CopiedBenchmark, EntryPoint
