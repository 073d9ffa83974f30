"""The synthetic LM token stream (``pipeline.py``)."""
from repro_torch.data.pipeline import TokenPipeline, make_lm_batch  # noqa: F401
