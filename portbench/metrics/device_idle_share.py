"""device_idle_share: the share of the traced window in which no
operation ran on the device, %.  Read as ``.join`` and
``.serve``."""
from portbench.readers import idle_share


def read(run):
    return idle_share(run)
