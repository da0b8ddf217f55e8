"""DistributedStrategy (port of `paddle_tpu.distributed.fleet.strategy`;
reference `fleet/base/distributed_strategy.py:104` + proto
`framework/distributed_strategy.proto:122`). Plain typed config: each
field picks a train step or an option of one in
`Fleet.build_sharded_train_step` (pipeline, LocalSGD, sequence parallel,
DGC, ZeRO, recompute, fp16 all-reduce), and `mesh_axes(world)` lays the
hybrid degrees over the world's ranks."""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class _Cfg(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        # toggles (reference proto field names kept)
        self.amp = False
        self.amp_configs = _Cfg(init_loss_scaling=32768.0, use_pure_fp16=False,
                                custom_white_list=[], custom_black_list=[],
                                dtype="bfloat16")
        self.recompute = False
        self.recompute_configs = _Cfg(checkpoints=[])
        self.gradient_merge = False
        self.gradient_merge_configs = _Cfg(k_steps=1, avg=True)
        self.sharding = False
        self.sharding_configs = _Cfg(stage=1, fuse_broadcast_MB=32,
                                     hybrid_dp=False,
                                     sharding_degree=1)
        self.pipeline = False
        self.pipeline_configs = _Cfg(accumulate_steps=1, micro_batch_size=1)
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Cfg(tensor_parallel_degree=1)
        self.sequence_parallel = False
        self.sequence_parallel_configs = _Cfg(degree=1, impl="ring")
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.dgc_configs = _Cfg(momentum=0.9, sparsity=0.999,
                                rampup_step=1)
        self.localsgd = False
        self.localsgd_configs = _Cfg(k_steps=4, begin_step=1)
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = _Cfg(init_k_steps=4, begin_step=1)
        self.fp16_allreduce = False
        self.a_sync = False
        self.a_sync_configs = _Cfg(k_steps=0, geo=False)
        self.hierarchical_allreduce = False
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.last_comm_group_size_MB = 1
        self.fuse_all_reduce_ops = True

    # hybrid topology (modern fleet): degrees per mesh axis
    @property
    def hybrid_configs(self):
        return getattr(self, "_hybrid", None) or {
            "dp_degree": -1, "mp_degree": 1, "pp_degree": 1, "sp_degree": 1}

    @hybrid_configs.setter
    def hybrid_configs(self, cfg):
        base = {"dp_degree": -1, "mp_degree": 1, "pp_degree": 1,
                "sp_degree": 1}
        base.update(cfg or {})
        self._hybrid = base

    def mesh_axes(self, n_devices):
        """Resolve degrees into a mesh axes dict."""
        h = dict(self.hybrid_configs)
        if self.tensor_parallel:
            h["mp_degree"] = max(
                h.get("mp_degree", 1),
                self.tensor_parallel_configs.get("tensor_parallel_degree", 1))
        if self.pipeline:
            h["pp_degree"] = max(h.get("pp_degree", 1), 2)
        if self.sequence_parallel:
            h["sp_degree"] = max(
                h.get("sp_degree", 1),
                self.sequence_parallel_configs.get("degree", 1))
        axes = {}
        known = 1
        for name, key in (("mp", "mp_degree"), ("pp", "pp_degree"),
                          ("sp", "sp_degree")):
            d = int(h.get(key, 1) or 1)
            if d > 1:
                axes[name] = d
                known *= d
        dp = h.get("dp_degree", -1)
        axes["dp"] = (n_devices // known) if dp in (-1, None) else int(dp)
        return {"dp": axes.pop("dp"), **axes}

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"
