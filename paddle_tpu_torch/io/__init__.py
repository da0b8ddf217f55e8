from .dataloader import (DataLoader, WorkerInfo,  # noqa: F401
                         default_collate_fn, get_worker_info)
from .dataset import (ChainDataset, ComposeDataset,  # noqa: F401
                      ConcatDataset, Dataset, IterableDataset, Subset,
                      TensorDataset, random_split)
from .device_loader import DeviceFeeder  # noqa: F401
from .packing import PackingCollator, suggest_rows  # noqa: F401
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      WeightedRandomSampler)
