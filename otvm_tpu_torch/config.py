"""Configuration, the port's own copy of otvm_tpu/config.py: dataclasses
carrying the reference's yacs names (config.py:4-49), so settings
translate one to one."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class SystemConfig:
    num_workers: int = 8
    random_seed: int = 111
    outdir: str = "train_log"
    testmode: bool = False          # smoke-test short-circuit (config.py:14)


@dataclasses.dataclass
class DatasetConfig:
    path: str = "PATH/TO/DATASET"
    min_edge_length: int = 1088


@dataclasses.dataclass
class TestConfig:
    memory_max_num: int = 5         # 2: first & prev, 0: first, 1: prev, 3+: multi
    memory_skip_frame: int = 10


@dataclasses.dataclass
class TrainConfig:
    stage: int = 1
    batch_size: int = 4             # global batch
    base_lr: float = 1e-5
    lr_strategy: str = "stair"      # 'stair' | 'poly' | 'const'
    weight_decay: float = 1e-4
    train_input_size: Tuple[int, int] = (320, 320)
    frame_num: int = 3
    freeze_bn: bool = True          # FrozenBatchNorm makes this structural
    optimizer: str = "radam"
    total_epochs: int = 200
    image_freq: int = -1
    save_every_epoch: int = 20
    # beyond the reference (it has no AMP): the network's forward and
    # backward in bf16, with fp32 master weights and optimizer state; the
    # losses stay fp32
    bf16: bool = False


@dataclasses.dataclass
class AlphaConfig:
    model: str = "fba"
    arch: str = "resnet50_GN_WS"    # or "resnet50_BN" (models/fba.py ENCODER_ARCHS)


@dataclasses.dataclass
class Config:
    system: SystemConfig = dataclasses.field(default_factory=SystemConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    test: TestConfig = dataclasses.field(default_factory=TestConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    alpha: AlphaConfig = dataclasses.field(default_factory=AlphaConfig)
    # > 1: the width-scaled model (channels / scale, one bottleneck per
    # trunk stage), same module tree; the tests' model
    model_scale: int = 1
    # STM trunk norm: 'frozen_bn' (the reference, for pretrained
    # statistics) or 'gn' (the from-scratch recipe; no running stats)
    stm_norm: str = "frozen_bn"


def get_cfg_defaults() -> Config:
    return Config()


TRIMAP_WIDTH_KERNELS = {"narrow": 5, "medium": 12, "wide": 20}  # eval.py:67-72

MODEL_NAMES = {1: "s1_OTVM_alpha", 2: "s2_OTVM_alpha", 3: "s3_OTVM", 4: "s4_OTVM"}


def get_model_name(cfg: Config) -> str:
    """helpers.py:323-328."""
    return MODEL_NAMES[cfg.train.stage]
