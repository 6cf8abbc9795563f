from repro_torch.ft.channel import BandwidthDrift, LossyChannel, RetryPolicy
from repro_torch.ft.failures import (FailureSchedule, FailureWindow, StragglerDrift,
                               merge_overlaps)

__all__ = ["BandwidthDrift", "FailureSchedule", "FailureWindow",
           "LossyChannel", "RetryPolicy", "StragglerDrift", "merge_overlaps"]
