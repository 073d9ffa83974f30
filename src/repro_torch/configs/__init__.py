"""Workload configs: the paper's KNN join problem sizes.  (The LM
architecture registry of the JAX package is not ported yet.)"""
from repro_torch.configs.paper_knn import SYNTHETIC, YEAST_WORM, JoinConfig

__all__ = ["JoinConfig", "SYNTHETIC", "YEAST_WORM"]
