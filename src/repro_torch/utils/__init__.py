from repro_torch.utils.logging import get_logger, log_event, set_json_logging
from repro_torch.utils.timing import Timer, timed

__all__ = ["get_logger", "log_event", "set_json_logging", "Timer", "timed"]
