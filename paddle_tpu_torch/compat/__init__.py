"""Source-level compatibility shims for the reference's legacy config
surfaces. `trainer_config_helpers` lets the reference's own DSL config
files (python/paddle/trainer_config_helpers/tests/configs/*.py) run
unmodified against paddle_tpu_torch, over the port's ``v2`` layers (see
tests/test_torch_compat.py)."""
from . import trainer_config_helpers  # noqa: F401
