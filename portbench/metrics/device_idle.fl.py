"""device_idle.fl (%): share of an untraced FL round in which no
operation runs on the card (`device.idle_share`). Moves fl_round_s."""

from portbench.harness.device import idle_share as read  # noqa: F401
