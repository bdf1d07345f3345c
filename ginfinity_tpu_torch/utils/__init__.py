"""Device selection and run-log I/O for the port."""

from ginfinity_tpu_torch.utils.io import (
    log_information,
    log_setup,
    read_table,
    setup_and_read_input,
)

__all__ = ["log_setup", "log_information", "read_table", "setup_and_read_input"]
