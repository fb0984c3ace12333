from .logging import NULL_LOG, EventLog
from .profiling import Throughput, timed, trace

__all__ = ["NULL_LOG", "EventLog", "Throughput", "timed", "trace"]

