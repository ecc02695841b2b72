"""Training pipeline on one card (PyTorch port of sayuri_tpu.train.pipeline).

The update is the JAX package's optax chain, step for step:

- gradients of the 11-term loss (``train/loss.py``) through the net in
  training mode (masked batch renorm), f32, no autocast;
- macro-batches: the gradients of ``macro_factor`` micro-batches averaged
  as a running mean (optax.MultiSteps), one update from their mean; the
  parameters do not move in between;
- clipping by global norm first (``g / norm * max`` when norm >= max, no
  epsilon, unlike ``clip_grad_norm_``);
- SGD: coupled weight decay on every parameter, then Nesterov momentum 0.9
  (``torch.optim.SGD(nesterov=True, weight_decay=...)``); Adam: AdamW with
  decay scaled by the learning rate, eps 1e-8;
- the learning rate: step schedule with linear warmup, counted in optimizer
  updates; ``steps``, ``samples``, the SWA cadence and the batch-norm
  statistics advance on every micro-batch;
- SWA: a running average of the parameters every ``swa_steps`` steps, the
  count capped at ``swa_max_count``;
- a non-finite loss raises ``FloatingPointError`` (after the step).

The checkpoint (``.ckpt``) is the port's own format: ``torch.save`` of the
model, optimizer and SWA state, the counters, the configs and ``extra``,
written to a ``.tmp`` and then renamed into place.
"""

from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path

import torch

from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
from sayuri_tpu_torch.train.loss import compute_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Learner knobs (the Train block of the reference's setting.json)."""

    optimizer: str = "SGD"
    batch_size: int = 256
    macro_factor: int = 1          # gradient accumulation steps
    weight_decay: float = 1e-4
    lr_schedule: tuple = ((0, 5e-3),)
    warmup_steps: int = 0
    grad_clip: float = 10000.0
    swa_max_count: int = 16
    swa_steps: int = 100
    soft_loss_weight: float = 0.1


def lr_at(cfg: TrainConfig, updates: int) -> float:
    """Step schedule + linear warmup, at a count of optimizer updates."""
    lr = cfg.lr_schedule[0][1]
    for s, v in cfg.lr_schedule:
        if updates >= s:
            lr = v
    if cfg.warmup_steps > 0:
        lr = lr * min(1.0, (updates + 1.0) / cfg.warmup_steps)
    return lr


class Trainer:
    """One net on one device. ``init_state`` (a state dict of the net's
    parameters and statistics) replaces the seeded random start; SWA starts
    as a copy of the first parameters either way."""

    def __init__(self, net_cfg: NetConfig, cfg: TrainConfig, seed: int = 0,
                 device="cuda", init_state=None):
        self.net_cfg = net_cfg
        self.cfg = cfg
        self.device = torch.device(device)
        net = SayuriNet(net_cfg).init_random(seed)
        if init_state is not None:
            net.load_state_dict(init_state)
        self.net = net.to(self.device).train()
        self.params = list(self.net.parameters())
        self.swa_params = {k: p.detach().clone() for k, p in self.net.named_parameters()}
        self.swa_count = 0
        self.steps = 0          # micro-batches
        self.samples = 0
        self.updates = 0        # optimizer updates: the learning rate's count
        self.mini_step = 0      # micro-batches in the current macro-batch
        self.acc_grads = [torch.zeros_like(p) for p in self.params] \
            if cfg.macro_factor > 1 else None
        if cfg.optimizer.lower() == "adam":
            self.opt = torch.optim.AdamW(self.params, lr=lr_at(cfg, 0), betas=(0.9, 0.999),
                                         eps=1e-8, weight_decay=cfg.weight_decay)
        else:
            self.opt = torch.optim.SGD(self.params, lr=lr_at(cfg, 0), momentum=0.9,
                                       nesterov=True, weight_decay=cfg.weight_decay)

    def _batch(self, planes, targets):
        return (torch.as_tensor(planes, device=self.device),
                {k: torch.as_tensor(v, device=self.device) for k, v in targets.items()})

    @staticmethod
    def _floats(parts):
        return dict(zip(parts, torch.stack([v.detach() for v in parts.values()]).tolist()))

    def train_batch(self, planes, targets):
        """One micro-batch (numpy or tensors): the loss, its gradients, and
        an optimizer update when the macro-batch is full. Returns the loss
        parts as floats; raises FloatingPointError on a non-finite loss."""
        cfg = self.cfg
        planes, targets = self._batch(planes, targets)
        outputs = self.net(planes)
        loss, parts = compute_loss(outputs, targets, planes[..., -1:], cfg.soft_loss_weight)
        grads = list(torch.autograd.grad(loss, self.params))
        with torch.no_grad():
            self._update(grads)
            self.steps += 1
            self.samples += planes.shape[0]
            if self.steps % cfg.swa_steps == 0:
                w = 1.0 / (1.0 + min(self.swa_count, cfg.swa_max_count))
                for k, p in self.net.named_parameters():
                    s = self.swa_params[k]
                    s.add_(w * (p - s))
                self.swa_count = min(self.swa_count + 1, cfg.swa_max_count)
        out = self._floats(parts)
        if not math.isfinite(out["loss"]):
            raise FloatingPointError(f"NaN/inf loss at step {self.steps}")
        return out

    def _update(self, grads):
        cfg = self.cfg
        if self.acc_grads is not None:
            n = self.mini_step
            self.acc_grads = [a + (g - a) / (n + 1) for a, g in zip(self.acc_grads, grads)]
            self.mini_step = (n + 1) % cfg.macro_factor
            if self.mini_step:
                return
            grads = self.acc_grads
            self.acc_grads = [torch.zeros_like(a) for a in grads]
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        keep = norm < cfg.grad_clip
        lr = lr_at(cfg, self.updates)
        for group in self.opt.param_groups:
            group["lr"] = lr
        for p, g in zip(self.params, grads):
            p.grad = torch.where(keep, g, g / norm * cfg.grad_clip)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.updates += 1

    @torch.no_grad()
    def eval_batch(self, planes, targets):
        """Loss parts of the net in inference mode (running statistics)."""
        planes, targets = self._batch(planes, targets)
        self.net.eval()
        try:
            outputs = self.net(planes)
        finally:
            self.net.train()
        _, parts = compute_loss(outputs, targets, planes[..., -1:], self.cfg.soft_loss_weight)
        return self._floats(parts)

    # ------------------------------------------------------------------
    # state and checkpoints
    # ------------------------------------------------------------------

    def checkpoint_name(self, num_chunks=None, window=None) -> str:
        """Reference weight naming: <name>-s{steps}[-c{chunks}][-w{window}]."""
        blocks = len(self.net_cfg.stack)
        ch = self.net_cfg.residual_channels
        name = f"sayuri-tpu-b{blocks}xc{ch}-s{self.steps}"
        if num_chunks is not None:
            name += f"-c{num_chunks}"
        if window is not None:
            name += f"-w{window}"
        return name

    # named as the JAX package's accessors; one device, nothing replicated
    def unreplicated_params(self):
        return {k: p.detach().clone() for k, p in self.net.named_parameters()}

    def unreplicated_swa_params(self):
        return {k: s.clone() for k, s in self.swa_params.items()}

    def unreplicated_batch_stats(self):
        return {k: b.detach().clone() for k, b in self.net.named_buffers()}

    def save_checkpoint(self, path: str, extra: dict | None = None):
        blob = {
            "model": self.net.state_dict(),
            "optimizer": self.opt.state_dict(),
            "swa_params": self.swa_params,
            "acc_grads": self.acc_grads,
            "swa_count": self.swa_count,
            "steps": self.steps,
            "samples": self.samples,
            "updates": self.updates,
            "mini_step": self.mini_step,
            "net_cfg": dataclasses.asdict(self.net_cfg),
            "train_cfg": dataclasses.asdict(self.cfg),
            "extra": extra or {},
        }
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        tmp = str(path) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str):
        """Restore every tensor and counter of a checkpoint this trainer's
        configuration wrote; returns its ``extra``."""
        # on the CPU first: the optimizer moves its state to the parameters'
        # device and keeps Adam's step counts on the host
        blob = torch.load(path, map_location="cpu", weights_only=True)
        self.net.load_state_dict(blob["model"])
        self.opt.load_state_dict(blob["optimizer"])
        for k, s in self.swa_params.items():
            s.copy_(blob["swa_params"][k])
        if self.acc_grads is not None:
            self.acc_grads = [a.to(self.device) for a in blob["acc_grads"]]
        for k in ("swa_count", "steps", "samples", "updates", "mini_step"):
            setattr(self, k, int(blob[k]))
        return blob.get("extra", {})

    @staticmethod
    def latest_checkpoint(ckpt_dir: str):
        files = sorted(Path(ckpt_dir).glob("*.ckpt"), key=os.path.getmtime)
        return str(files[-1]) if files else None
