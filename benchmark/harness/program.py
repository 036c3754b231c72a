"""The program under test as the benchmark calls it: the port's
configuration classes built from a cell's files, and its model holding the
benchmark's weights.  Every other module of the harness reaches the program
through here or through the traffic drivers."""

from __future__ import annotations

from typing import Dict

import torch

from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.models.generator import Generator

MODEL_KEYS = ("embed", "stem_dim_num", "fc_hw_dim", "expansion", "reduction", "strides",
              "num_blocks", "lower_width", "norm", "act", "bias", "single_res", "sigmoid",
              "branch_type", "compute_dtype")


def model_config(cfg: dict, **override) -> ModelConfig:
    m = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()
         if k in MODEL_KEYS}
    return ModelConfig(**m, **override)


def train_config(cfg: dict, traffic: dict, seed: int, **model_override) -> TrainConfig:
    """The recipe of ``cfg["train"]`` over its video at the traffic's
    batch size, the shuffle keyed by ``seed``."""
    t, v = cfg["train"], cfg["video"]
    return TrainConfig(
        model=model_config(cfg, **model_override),
        data=DataConfig(dataset="synth", batch_size=traffic["batch_size"],
                        synthetic_frames=v["frames"], synthetic_hw=(v["height"], v["width"])),
        epochs=t["epochs"], warmup=t["warmup"], lr=t["lr"], lr_type=t["lr_type"],
        beta=t["beta"], loss_type=t["loss_type"], lw=t["lw"],
        manual_seed=int(seed),
    )


@torch.no_grad()
def load_weights(model: Generator, weights: Dict[str, torch.Tensor]) -> Generator:
    """Copy the benchmark's weights into the model's parameters, by name;
    the two sets of names have to be the same."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the model's parameters {sorted(set(params) ^ set(weights))} are not "
                         "the reference's")
    for k, p in params.items():
        if tuple(p.shape) != tuple(weights[k].shape):
            raise ValueError(f"{k}: the model has {tuple(p.shape)}, the reference "
                             f"{tuple(weights[k].shape)}")
        p.copy_(weights[k])
    return model
