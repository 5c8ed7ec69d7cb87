from .log import Log, register_log_callback
