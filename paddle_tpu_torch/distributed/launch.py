"""python -m paddle_tpu_torch.distributed.launch: the reference's
`python -m paddle.distributed.launch` entry, the CLI of fleet.launch."""
from .fleet.launch import launch, main  # noqa: F401

if __name__ == "__main__":
    launch()
