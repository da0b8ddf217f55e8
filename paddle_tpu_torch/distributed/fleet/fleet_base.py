"""Fleet facade (port of `paddle_tpu.distributed.fleet.fleet_base`;
reference `fleet/base/fleet_base.py:63` Fleet, `:130` init, `:598`
distributed_optimizer, `:643` distributed_model, `:1070` minimize).

`fleet.init` joins the world (`distributed.init_parallel_env`: one
process a card) and lays the strategy's hybrid degrees over its ranks as
the mesh (`DistributedStrategy.mesh_axes(world)`). `distributed_optimizer`
and `distributed_model` wrap the user's objects and carry the strategy;
`build_sharded_train_step` picks the train step from it, as the JAX
package's does (`fleet_base.py:145-175`):
- `pipeline` -> `parallel.pipeline.make_pipeline_train_step`
  (`accumulate_steps` microbatches, `recompute`);
- `localsgd` / `adaptive_localsgd` -> `parallel.localsgd.
  make_local_train_step` (`k_steps` / `init_k_steps`, `begin_step`);
- else `parallel.spmd.make_sharded_train_step`: ZeRO stage
  `sharding_configs["stage"]` when `sharding` (else 0), the sp axis when
  `sequence_parallel`, `recompute`, fp16 gradients for the all-reduce
  when `fp16_allreduce`, DGC with `dgc_configs`' momentum and sparsity.
The parameter-server side (`init_worker`, `init_server`, `run_server`,
`stop_worker`) drives `distributed.ps.the_one_ps()`, as the JAX
package's does (`fleet_base.py:178-203`). `init(is_collective=False)`
(a parameter-server job) joins no collective world: its servers and
trainers meet over the servers' TCP endpoints, and a card stays free for
the trainers (the JAX package's `init_parallel_env` joins no world on
one host either).
"""
from __future__ import annotations

from typing import Optional

from ...parallel.mesh import create_mesh, get_mesh
from ..env import get_rank, get_world_size, init_parallel_env
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase
from .strategy import DistributedStrategy

__all__ = ["Fleet", "fleet"]


class _DistributedOptimizer:
    """The user's optimizer with the strategy beside it (the reference's
    composed meta-optimizer chain)."""

    def __init__(self, optimizer, strategy, fleet_obj):
        self.user_defined_optimizer = optimizer
        self.user_defined_strategy = strategy
        self._fleet = fleet_obj

    def __getattr__(self, name):
        return getattr(self.user_defined_optimizer, name)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self.user_defined_optimizer.minimize(
            loss, startup_program, parameters, no_grad_set)

    def step(self):
        return self.user_defined_optimizer.step()

    def clear_grad(self):
        return self.user_defined_optimizer.clear_grad()


class _DistributedModel:
    """reference `fleet_base.py:643` distributed_model: the layer, whose
    forward is unchanged (the train step does the distribution)."""

    def __init__(self, layer, fleet_obj):
        self._layers = layer
        self._fleet = fleet_obj

    def __getattr__(self, name):
        return getattr(self._layers, name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_collective = True
        self._inited = False

    # -- lifecycle ----------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, strategy=None):
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._is_collective = is_collective
        self._strategy = strategy or DistributedStrategy()
        if is_collective:
            init_parallel_env()
            create_mesh(self._strategy.mesh_axes(get_world_size()))
        self._inited = True
        return self

    @property
    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_first_worker(self):
        return get_rank() == 0

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints() if self._role_maker \
            else ["127.0.0.1:6170"]
        return ",".join(eps) if to_string else eps

    def is_worker(self):
        return True

    def is_server(self):
        return (self._role_maker is not None
                and getattr(self._role_maker, "_is_server", False))

    def barrier_worker(self):
        self.util.barrier()

    # -- training -----------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        return _DistributedOptimizer(optimizer, self._strategy, self)

    def distributed_model(self, model):
        """The model for the strategy's step; a model marked by
        `models.tp_annotate` is cut to this rank's 'mp' slices here (the
        JAX package lays its parameters out by their specs here)."""
        if get_mesh() is not None:
            from ..tensor_parallel import shard_megatron
            shard_megatron(getattr(model, "_layers", model))
        return _DistributedModel(model, self)

    def batch_placement(self):
        """Per-leaf placement of a training batch, as the strategy's step
        splits it (dim 0 over 'dp', the sequence over 'sp' when
        sequence_parallel); None without a mesh."""
        from ...parallel.spmd import batch_placement
        if get_mesh() is None:
            return None
        st = self._strategy or DistributedStrategy()
        return batch_placement(
            get_mesh(),
            sp_axis="sp" if getattr(st, "sequence_parallel", False)
            else None)

    def build_sharded_train_step(self, layer, optimizer, loss_fn,
                                 donate=True):
        """The strategy's train step: (step, state) (see the module
        docstring)."""
        from ...parallel.spmd import make_sharded_train_step
        st = self._strategy or DistributedStrategy()
        opt = getattr(optimizer, "user_defined_optimizer", optimizer)
        layer = getattr(layer, "_layers", layer)
        if st.pipeline:
            from ...parallel.pipeline import make_pipeline_train_step
            n_micro = int(st.pipeline_configs.get("accumulate_steps", 1))
            return make_pipeline_train_step(
                layer, opt, loss_fn, n_micro=max(n_micro, 1),
                mesh=get_mesh(), recompute=st.recompute)
        if st.localsgd or st.adaptive_localsgd:
            from ...parallel.localsgd import make_local_train_step
            cfg = (st.adaptive_localsgd_configs if st.adaptive_localsgd
                   else st.localsgd_configs)
            return make_local_train_step(
                layer, opt, loss_fn, mesh=get_mesh(),
                k_steps=cfg.get("init_k_steps", cfg.get("k_steps", 4)),
                begin_step=cfg.get("begin_step", 1),
                adaptive=st.adaptive_localsgd)
        return make_sharded_train_step(
            layer, opt, loss_fn, mesh=get_mesh(), donate=donate,
            zero_stage=(st.sharding_configs.get("stage", 1)
                        if st.sharding else 0),
            sp_axis="sp" if st.sequence_parallel else None,
            recompute=st.recompute,
            grad_dtype=("float16" if st.fp16_allreduce else None),
            dgc=st.dgc,
            dgc_momentum=st.dgc_configs.get("momentum", 0.9),
            dgc_sparsity=st.dgc_configs.get("sparsity", 0.999))

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.backward()
        return [], []

    # -- the parameter server (distributed/ps) -----------------------------
    def init_worker(self):
        from ..ps.runtime import the_one_ps
        the_one_ps().init_worker()

    def init_server(self, *args, **kwargs):
        from ..ps.runtime import the_one_ps
        the_one_ps().init_server(*args, **kwargs)

    def run_server(self):
        from ..ps.runtime import the_one_ps
        the_one_ps().run_server()

    def stop_worker(self):
        from ..ps.runtime import the_one_ps
        the_one_ps().stop_worker()

    def save_persistables(self, executor=None, dirname=None,
                          main_program=None, mode=0):
        """Writes an empty state to `dirname`/fleet_persistables.pdparams
        and not the tables, as the JAX package's does (its
        `fleet_base.py:195-201`; ROADMAP C39): save a table through
        `FleetWrapper.save_model` or `PsClient.save`."""
        from ...framework.io_state import save
        if dirname:
            import os
            os.makedirs(dirname, exist_ok=True)
            save({}, os.path.join(dirname, "fleet_persistables.pdparams"))

    @property
    def util(self):
        from .utils import UtilBase
        return UtilBase()


fleet = Fleet()
