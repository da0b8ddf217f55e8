"""Pretrained weight files (port of `paddle_tpu.utils.download`;
reference `python/paddle/utils/download.py`).

Nothing is fetched: a file resolves from a local cache directory
(`$PADDLE_TPU_WEIGHTS_DIR`, else ~/.cache/paddle_tpu/weights), and an
absent one raises FileNotFoundError saying where to put it."""
from __future__ import annotations

import os
import os.path as osp

__all__ = ["get_weights_path_from_url", "get_path_from_url", "WEIGHTS_HOME"]

WEIGHTS_HOME = os.environ.get(
    "PADDLE_TPU_WEIGHTS_DIR",
    osp.expanduser("~/.cache/paddle_tpu/weights"))


def get_weights_path_from_url(url: str, md5sum=None) -> str:
    fname = osp.basename(url.split("?")[0])
    local = osp.join(WEIGHTS_HOME, fname)
    if osp.exists(local):
        return local
    raise FileNotFoundError(
        f"pretrained weights {fname} not found in {WEIGHTS_HOME}, and "
        f"nothing is downloaded. Place the file there (source url: {url}).")


def get_path_from_url(url, root_dir=None, md5sum=None, check_exist=True,
                      decompress=True):
    root_dir = root_dir or WEIGHTS_HOME
    local = osp.join(root_dir, osp.basename(url.split("?")[0]))
    if osp.exists(local):
        return local
    raise FileNotFoundError(f"{local} missing; nothing is downloaded "
                            f"(source url: {url})")
