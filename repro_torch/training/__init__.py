"""Training (counterpart of ``repro.training``): AdamW, the train step,
checkpoints in the reference's layout, compression, fault tolerance."""

from .optimizer import AdamWConfig, init_opt_state, adamw_update  # noqa: F401
from .train_loop import TrainConfig, make_train_step, init_train_state  # noqa: F401
from .train_loop import ShardedTrainState, shard_train_state, gather_train_state  # noqa: F401
from .checkpoint import save_checkpoint, restore_checkpoint, latest_step  # noqa: F401
from .compression import CompressionConfig  # noqa: F401
