"""The optimizer (``adamw.py``), the learning-rate schedule
(``schedule.py``) and int8 gradient compression (``compress.py``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
