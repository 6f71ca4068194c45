"""Typed configuration bundles: the port's copy of the JAX package's
``config.py``, field for field.

The dataclasses bundle the tutorial-default hyperparameters of the count
and image workflows into serializable records. Every train and data entry
point still takes plain keyword arguments; a config is a convenience.
:func:`save_config` writes the JSON the JAX package writes, byte for byte,
and :func:`load_config` reads either package's files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class DataConfig:
    """create_visium_dataset arguments."""

    use_count: bool = True
    use_image: bool = False
    spatial: bool = True
    count_suffix: str = ".unified.tsv.gz"
    minimum_detection_rate: Optional[float] = 0.02
    patch_size_px: Optional[int] = None
    patch_size_um: Optional[float] = 100.0
    select_genes: Optional[Sequence[str]] = None

    def as_kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SpotTrainConfig:
    """train_spotwise defaults (count-f: Adam 1e-4 batch 128; image-f: 1e-3)."""

    learning_rate: float = 1e-4
    num_epochs: int = 10
    batch_size: int = 128
    shuffle_seed: int = 0
    redraw_every: Optional[int] = None  # Performer/scBERT projection redraw

    def as_kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class GridTrainConfig:
    """train_gridwise defaults (Adam 1e-3 on g, batch of 1 array)."""

    learning_rate: float = 1e-3
    f_lr: Optional[float] = None       # joint f fine-tuning when set
    accum_iters: int = 1
    num_epochs: int = 10
    batch_size: int = 1
    shuffle_seed: int = 0

    def as_kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class GridNetConfig:
    """GridNetHex construction parameters."""

    n_classes: int = 7
    use_bn: bool = True
    patch_chunk: Optional[int] = None   # atonce_patch_limit analog
    f_dim: Optional[int] = None


@dataclasses.dataclass
class DenseNetConfig:
    """DenseNet-121 tutorial configuration (Tutorial_visium_image cell 8)."""

    growth_rate: int = 32
    block_config: Tuple[int, ...] = (6, 12, 24, 16)
    num_init_features: int = 64
    bn_size: int = 4
    drop_rate: float = 0.0
    num_classes: int = 7
    small_inputs: bool = False
    efficient: bool = False


def save_config(cfg, path):
    """Write a config dataclass as JSON."""
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2)


def load_config(cls, path):
    """Read a config dataclass from JSON, ignoring unknown fields (configs
    written by newer versions still load). Tuple-typed fields are restored
    from JSON arrays (e.g. DenseNetConfig.block_config) so round-tripped
    configs compare equal."""
    with open(path) as fh:
        raw = json.load(fh)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in raw:
            continue
        v = raw[f.name]
        if isinstance(v, list) and str(f.type).lower().startswith(
                ("tuple", "typing.tuple")):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)
