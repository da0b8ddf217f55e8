"""paddle.distributed.fleet (port): only the launcher so far; the
collective fleet API (`fleet_base`, `strategy`, `role_maker`, ...) and
the parameter server are ROADMAP A6's later items."""
from . import launch  # noqa: F401
