"""engine.device_ms: the mean ``device_ms`` of the ``engine.r_block`` spans,
ms: the time on the device's clock between two CUDA events, recorded as an
R block's launch begins and as its pull begins.  It counts the driver's
device work and any idle the device spends waiting for the host's
launches in between; it is not the device's busy time.  ``None`` where no
span carries it.  Read as ``.join``."""
import numpy as np


def read(run):
    ms = [e["attrs"]["device_ms"] for e in run.spans
          if e["name"] == "engine.r_block" and "device_ms" in e.get("attrs", {})]
    return float(np.mean(ms)) if ms else None
