"""Shared by the tests/test_torch_ps*.py, test_torch_host_embedding.py and
test_torch_transpiler.py files: the port's parameter server held to the
JAX package's in one process.

- `on_the_cpu`: the port's default device is the card; these tests ask
  for the CPU and leave the default as they found it.
- `heads(seed)`: the same small dense head in both packages (pooled
  embeddings -> Linear -> ReLU -> Linear), the JAX head's weights carried
  into the port's (a Linear weight is [in, out] in the JAX package,
  [out, in] in the port).
- `batches(n, seed)`: seeded (ids [B, SEQ], labels [B]) batches with
  duplicate ids inside a batch.
- `serve(pkg, configs)`: a started server of either package on
  127.0.0.1:0.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.distributed import ps as tps

PS = {"jax": jps, "port": tps}

DIM, SEQ, B, VOCAB, HID, OUT = 8, 5, 6, 40, 16, 4


@pytest.fixture(autouse=True)
def on_the_cpu():
    before = T.framework.place.default_place()
    T.set_device("cpu")
    yield
    T.set_device(before)


class JHead(J.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = J.nn.Linear(DIM, HID)
        self.fc2 = J.nn.Linear(HID, OUT)

    def forward(self, emb_flat, labels):
        from paddle_tpu.framework.tensor import Tensor
        e = Tensor(emb_flat).reshape([-1, SEQ, DIM]).mean(axis=1)
        return self.fc2(J.nn.functional.relu(self.fc1(e)))


class THead(T.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = T.nn.Linear(DIM, HID)
        self.fc2 = T.nn.Linear(HID, OUT)

    def forward(self, emb_flat, labels):
        e = emb_flat.reshape(-1, SEQ, DIM).mean(dim=1)
        return self.fc2(torch.relu(self.fc1(e)))


def carry(jlayer, tlayer):
    """The JAX layer's parameters into the port's, by name."""
    js = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    with torch.no_grad():
        for k, p in tlayer.named_parameters():
            v = js[k]
            if v.ndim == 2:
                v = v.T
            p.copy_(torch.from_numpy(np.array(v, copy=True)))


def heads(seed=7):
    J.seed(seed)
    jh = JHead()
    th = THead()
    carry(jh, th)
    return jh, th


def losses(pkg):
    """loss_fn(out, data) of `pkg` over the head's logits and labels."""
    if pkg is J:
        ce = J.nn.CrossEntropyLoss()

        def jloss(out, data):
            from paddle_tpu.framework.tensor import Tensor
            return ce(out, Tensor(data[0]))
        return jloss
    ce = T.nn.CrossEntropyLoss()
    return lambda out, data: ce(out, data[0])


def batches(n, seed=11, vocab=VOCAB):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab // 2, size=(B, SEQ)).astype("int64"),
             rs.randint(0, OUT, size=(B,)).astype("int64"))
            for _ in range(n)]


def serve(pkg, configs, n_workers=1):
    return PS[pkg].PsServer("127.0.0.1:0", configs,
                            n_workers=n_workers).start()


def endpoint(server):
    return f"127.0.0.1:{server.port}"
