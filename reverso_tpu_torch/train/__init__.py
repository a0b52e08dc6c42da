from .clip import ClipTrainer, siglip_loss, param_partition_spec
