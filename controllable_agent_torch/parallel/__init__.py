from .mesh import make_dp_offline_trainer, make_dp_trainer, make_group, shard_batch

__all__ = ["make_dp_offline_trainer", "make_dp_trainer", "make_group", "shard_batch"]
