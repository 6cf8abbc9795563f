"""device_idle.pod (%): share of an untraced pod round in which no
operation runs on the card (`device.idle_share`). Moves pod_round_s."""

from portbench.harness.device import idle_share as read  # noqa: F401
