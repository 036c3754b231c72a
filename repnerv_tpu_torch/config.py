"""The model and run configuration: the JAX package's ``config`` module,
which is plain dataclasses and imports no JAX, shared so that an artifact's
``model_cfg`` means the same on both sides."""

from repnerv_tpu.config import (  # noqa: F401
    ModelConfig,
    TrainConfig,
    head_plan,
    output_hw,
    stage_channels,
)
