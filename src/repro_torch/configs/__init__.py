"""Configs: the LM architecture registry (``base.py``, one module per
architecture, as the JAX package's ``configs/``) and the paper's KNN join
problem sizes (``paper_knn.py``)."""
from repro_torch.configs.base import ModelConfig, REGISTRY, all_arch_names, get_config, register
from repro_torch.configs.paper_knn import SYNTHETIC, YEAST_WORM, JoinConfig

__all__ = ["ModelConfig", "REGISTRY", "get_config", "register", "all_arch_names",
           "JoinConfig", "SYNTHETIC", "YEAST_WORM"]
