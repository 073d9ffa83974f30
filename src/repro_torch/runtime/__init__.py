from repro_torch.runtime.fault import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    RetryPolicy,
    ShardLostError,
    Supervisor,
    corrupt_checkpoint_leaf,
)
