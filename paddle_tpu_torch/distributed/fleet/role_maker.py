"""Role makers (port of `paddle_tpu.distributed.fleet.role_maker`;
reference `fleet/base/role_maker.py:357` RoleMakerBase / `:528`
PaddleCloudRoleMaker): the cluster's topology from the launcher's
PADDLE_* env (PADDLE_TRAINER_ID, PADDLE_TRAINER_ENDPOINTS,
PADDLE_PSERVERS_IP_PORT_LIST, TRAINING_ROLE), or given by the user."""
from __future__ import annotations

import os

__all__ = ["RoleMakerBase", "PaddleCloudRoleMaker", "UserDefinedRoleMaker",
           "Role"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role = Role.WORKER
        self._current_id = 0

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    @property
    def _is_server(self):
        return self.is_server()

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints or ["127.0.0.1:6170"]

    def get_pserver_endpoints(self):
        return self._server_endpoints


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the same env contract the reference launcher writes:
    PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS / PADDLE_PSERVERS_IP_PORT_LIST
    / TRAINING_ROLE."""

    def __init__(self, is_collective=True, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._generate_role()

    def _generate_role(self):
        self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        ps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in ps.split(",") if e]
        role = os.environ.get("TRAINING_ROLE", "TRAINER")
        if role == "PSERVER":
            self._role = Role.SERVER
            self._current_id = int(os.environ.get("PADDLE_PORT_ID",
                                                  os.environ.get(
                                                      "POD_ID", "0")))
        else:
            self._role = Role.WORKER

    def _get_pserver_endpoints(self):
        return self._server_endpoints


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=False, init_gloo=False, path=None,
                 current_id=0, role=Role.WORKER, worker_endpoints=None,
                 server_endpoints=None, worker_num=None, **kwargs):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = worker_endpoints or []
        self._server_endpoints = server_endpoints or []
