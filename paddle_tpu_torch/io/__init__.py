from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .dataset import Dataset, TensorDataset  # noqa: F401
from .packing import PackingCollator, suggest_rows  # noqa: F401
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequenceSampler)
