"""Data of the port: deterministic synthetic token streams and
calibration capture."""
from repro_torch.data.calibration import calibration_summary, \
    capture_calibration
from repro_torch.data.synthetic import (DataConfig, batches, data_config_for,
                                        host_batch, sample_tokens)

__all__ = ["DataConfig", "batches", "data_config_for", "host_batch",
           "sample_tokens", "calibration_summary", "capture_calibration"]
