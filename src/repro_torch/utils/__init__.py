from repro_torch.utils.logging import get_logger, log_event, set_json_logging

__all__ = ["get_logger", "log_event", "set_json_logging"]
