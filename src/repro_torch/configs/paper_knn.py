"""The paper's own workload configs: KNN join problem sizes (§5).

Not a model config: join jobs are configured separately.  A copy of the
JAX package's ``configs/paper_knn.py``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    name: str
    n_r: int
    n_s: int
    dim: int
    nnz_mean: int
    k: int = 5
    algorithm: str = "iiib"
    tile: int = 128
    r_block: int = 2048
    s_block: int = 2048


SYNTHETIC = JoinConfig(name="synthetic-10k", n_r=10_000, n_s=10_000, dim=10_000, nnz_mean=120)
YEAST_WORM = JoinConfig(
    name="yeast-worm", n_r=35_236, n_s=207_804, dim=20_000, nnz_mean=80
)
