from .logging import get_logger, StatusLog
from .profiling import StageTimer, Metrics
