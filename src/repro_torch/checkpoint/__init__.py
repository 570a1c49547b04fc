# repro_torch.checkpoint — atomic, crc-checked checkpoints in the JAX
# package's on-disk format (a snapshot restores in either package).
from . import checkpoint
from .checkpoint import latest_step, prune_old, restore, save
