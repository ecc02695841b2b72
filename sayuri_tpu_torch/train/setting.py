"""Reference setting.json importer (port of sayuri_tpu.train.setting).

The reference trainer is configured by a two-block JSON file: a
`NeuralNetwork` block (net architecture) and a `Train` block
(optimizer/loop/data knobs). `load_setting` parses that schema, the v1-v4
`PolicyExtract`/`ValueExtract` aliases included, into the port's
NetConfig, TrainConfig and LoopSetting, with the JAX package's defaults and
errors. `UseFp16` is read and not acted on: the trainer runs in f32.
`python -m sayuri_tpu_torch.tools.train_worker` is the matching worker.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Sequence

from sayuri_tpu_torch.models.network import NetConfig
from sayuri_tpu_torch.train.pipeline import TrainConfig


@dataclasses.dataclass(frozen=True)
class LoopSetting:
    """Train-block fields that drive the fit loop / data pipeline rather
    than the train step (config.py:26-58)."""

    steps_per_epoch: int = 1000
    validation_steps: int = 100
    verbose_steps: int = 1000
    max_steps_per_running: int = 16384000
    workers: int = 4
    buffer_size: int = 16000
    down_sample_rate: int = 16
    num_chunks: Optional[int] = None
    chunks_increasing_c: Optional[int] = None
    chunks_increasing_scale: float = 1.0
    chunks_increasing_alpha: float = 0.75
    chunks_increasing_beta: float = 0.4
    policy_surprise_factor: float = 0.0
    use_fp16: bool = False
    train_dir: Optional[str] = None
    validation_dir: Optional[str] = None
    store_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ReferenceSetting:
    net: NetConfig
    train: TrainConfig
    loop: LoopSetting
    json_str: str = ""


def _policy_head_type(raw: Any) -> str:
    # config.py accepts either a bare string or {"Type": ..., ...}
    if isinstance(raw, dict):
        return str(raw.get("Type", "Normal"))
    return str(raw or "Normal")


def load_setting(source: str) -> ReferenceSetting:
    """Parse a reference setting.json (path or raw JSON string)."""
    if os.path.exists(source):
        with open(source) as f:
            json_str = f.read()
    else:
        json_str = source
    jdata = json.loads(json_str)

    network = jdata.get("NeuralNetwork")
    train = jdata.get("Train")
    if network is None or train is None:
        raise ValueError(
            "setting.json needs NeuralNetwork and Train blocks "
            "(train/torch/config.py:23-90)"
        )

    # --- NeuralNetwork block (config.py:64-90) ---
    policy_ch = network.get("PolicyExtract")  # v1~v4 alias
    if policy_ch is None:
        policy_ch = network.get("PolicyHeadChannels")
    value_ch = network.get("ValueExtract")
    if value_ch is None:
        value_ch = network.get("ValueHeadChannels")
    phead = _policy_head_type(network.get("PolicyHeadType", "Normal"))
    stack: Sequence[str] = tuple(network.get("Stack", []))
    for name in stack:
        base = name.replace("-SE", "")
        if base not in (
            "ResidualBlock",
            "BottleneckBlock",
            "NestedBottleneckBlock",
            "MixerBlock",
        ):
            raise ValueError(f"unknown stack block {name!r}")
    if network.get("ResidualChannels") is None or policy_ch is None \
            or value_ch is None:
        raise ValueError("ResidualChannels/PolicyHeadChannels/"
                         "ValueHeadChannels are required (config.py:86-90)")

    net = NetConfig(
        boardsize=int(network.get("MaxBoardSize", 19)),
        input_channels=int(network.get("InputChannels", 43)),
        residual_channels=int(network["ResidualChannels"]),
        stack=stack,
        se_ratio=int(network.get("SeRatio", 2)),
        policy_head_channels=int(policy_ch),
        value_head_channels=int(value_ch),
        policy_head_type=phead,
        activation=str(network.get("Activation", "relu")).lower(),
        renorm_max_r=float(train.get("RenormMaxR", 1)),
        renorm_max_d=float(train.get("RenormMaxD", 0)),
    )

    # --- Train block (config.py:26-58) ---
    lr_schedule = tuple(
        (int(s), float(v))
        for s, v in train.get("LearningRateSchedule", [[0, 0.2]])
    )
    tcfg = TrainConfig(
        optimizer=str(train.get("Optimizer", "SGD")),
        batch_size=int(train.get("BatchSize", 512)),
        macro_factor=int(train.get("MacroFactor", 1)),
        weight_decay=float(train.get("WeightDecay", 1e-4)),
        lr_schedule=lr_schedule,
        warmup_steps=int(train.get("WarmUpSteps", 0)),
        swa_max_count=int(train.get("SwaMaxCount", 16)),
        swa_steps=int(train.get("SwaSteps", 100)),
        soft_loss_weight=float(train.get("SoftLossWeight", 0.1)),
    )

    loop = LoopSetting(
        steps_per_epoch=int(train.get("StepsPerEpoch", 1000)),
        validation_steps=int(train.get("ValidationSteps", 100)),
        verbose_steps=int(train.get("VerboseSteps", 1000)),
        max_steps_per_running=int(
            train.get("MaxStepsPerRunning", 16384000)
        ),
        workers=int(train.get("Workers") or max((os.cpu_count() or 3) - 2, 1)),
        buffer_size=int(train.get("BufferSize", 16000)),
        down_sample_rate=int(train.get("DownSampleRate", 16)),
        num_chunks=train.get("NumberChunks"),
        chunks_increasing_c=train.get("ChunksIncreasingC"),
        chunks_increasing_scale=float(
            train.get("ChunksIncreasingScale", 1.0)
        ),
        chunks_increasing_alpha=float(
            train.get("ChunksIncreasingAlpha", 0.75)
        ),
        chunks_increasing_beta=float(
            train.get("ChunksIncreasingBeta", 0.4)
        ),
        policy_surprise_factor=float(
            train.get("PolicySurpriseFactor", 0.0)
        ),
        use_fp16=bool(train.get("UseFp16", False)),
        train_dir=train.get("TrainDirectory"),
        validation_dir=train.get("ValidationDirectory"),
        store_path=train.get("StorePath"),
    )
    if loop.train_dir is None or loop.store_path is None:
        raise ValueError(
            "TrainDirectory and StorePath are required (config.py:59-60)"
        )
    return ReferenceSetting(net=net, train=tcfg, loop=loop,
                            json_str=json_str)
