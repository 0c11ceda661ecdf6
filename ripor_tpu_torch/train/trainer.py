"""Trainer: train step + optimizer + loop, in PyTorch.

Port of ripor_tpu/train/trainer.py, which replaces the reference's forked
HF Trainer (tasks/trainer.py:104-977): weighted multi-loss accounting
(:232-243), gradient accumulation (:621-628), clipping + AdamW + linear
warmup/decay (HF defaults the reference inherits), and NaN-loss filtering
(:632-639).

The optimizer is written out (``AdamW``) so that it is the JAX package's
``optax.chain(clip_by_global_norm, adamw)`` step for step: clipping scales
only when the global norm exceeds the bound, with no epsilon; weight decay
enters the update after Adam's normalization and before the learning rate,
on every parameter; the learning rate of update n is the schedule at n,
counted from 0. Its state ({count, mu, nu} by parameter name) is the
optax state's, so a JAX run carries across (models/convert.py:
``train_state_from_jax``).

The model holds the live parameters; training runs in the model's dtype
and on its device. Mesh data parallelism and ZeRO opt-state sharding wait
for ROADMAP.md Queue 1 item 5 and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ripor_tpu_torch.train import losses as loss_lib

_ITEM5 = "(ROADMAP.md Queue 1 item 5, DP/TP)"


@dataclasses.dataclass
class TrainConfig:
    loss_type: str = "t5seq_aq_encoder_margin_mse"
    learning_rate: float = 1e-4
    warmup_steps: int = 0
    total_steps: int = 100_000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    grad_accum: int = 1
    loss_weights: Optional[Dict[str, float]] = None  # default: all 1.0 (arguments.py:109-141)
    # read by neither package: the trainer computes in the model's dtype
    # (float32 from run_train_from_config), as the JAX trainer does
    bf16_compute: bool = True
    # ZeRO-style Adam mu/nu sharding over a mesh: not ported (item 5)
    shard_opt_state: bool = False
    # Decoupled L2-SP anchor: each step, AFTER the optimizer update, params
    # relax toward the anchor checkpoint: p <- p - r*(p - anchor) with
    # r = l2sp_rate (see the JAX TrainConfig for why it is decoupled).
    # Requires anchor_params at Trainer construction.
    l2sp_rate: float = 0.0


@dataclasses.dataclass
class TrainState:
    """step: updates applied; params: the model's parameters by state_dict
    name (live tensors, updated in place); opt_state: ``AdamW.init``."""
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """optax.join_schedules of a linear warm-up 0 -> lr over
    max(warmup_steps, 1) counts and a linear decay lr -> 0 over
    max(total_steps - warmup_steps, 1), switching at warmup_steps."""
    lr, warm = cfg.learning_rate, cfg.warmup_steps
    n_warm = max(warm, 1)
    n_decay = max(cfg.total_steps - warm, 1)

    def schedule(count: int) -> float:
        if count < warm:
            return lr * min(max(count, 0), n_warm) / n_warm
        return lr * (1.0 - min(max(count - warm, 0), n_decay) / n_decay)
    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr_schedule,
    b1=0.9, b2=0.999, eps=1e-8, weight_decay)) over named tensors."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig):
        self.schedule = lr_schedule(cfg)
        self.max_norm = cfg.grad_clip
        self.weight_decay = cfg.weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], opt_state: Dict,
               params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Apply one update to ``params`` and ``opt_state`` in place;
        returns the global norm of ``grads`` (before clipping)."""
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        mus = [opt_state["mu"][k] for k in names]
        nus = [opt_state["nu"][k] for k in names]
        g_norm = global_norm(gs)
        scale = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                            self.max_norm / g_norm)
        gs = torch._foreach_mul(gs, scale)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, gs, alpha=1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
        lr = self.schedule(opt_state["count"])
        opt_state["count"] += 1
        n = opt_state["count"]
        denom = torch._foreach_div(nus, 1 - b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, 1 - b1 ** n)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-lr)
        return g_norm


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(cfg)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The dropout generator of step ``step``, a function of (seed, step)
    alone, as the JAX trainer's fold_in(rng, step): a resumed run draws
    what an uninterrupted one does."""
    s = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(s[0]))


def make_train_step(model, cfg: TrainConfig, tx: AdamW,
                    anchor_params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Callable:
    """The train step: (state, batch, generator) -> (state, metrics), the
    update applied in place. With cfg.grad_accum > 1 the batch tensors
    have a leading accumulation axis [accum, micro_bz, ...]; gradients and
    metrics are averaged over the micro-batches, each with a generator of
    its own drawn from ``generator``."""
    loss_fn = loss_lib.LOSS_FNS[cfg.loss_type]
    weights = cfg.loss_weights or {}

    def weighted_total(loss_dict):
        total = 0.0
        for name, value in loss_dict.items():
            total = total + weights.get(name, 1.0) * value
        return total

    def micro_step(batch, generator):
        """Forward and backward of one micro-batch; gradients accumulate
        into the parameters' .grad."""
        loss_dict = loss_fn(model, batch, train=True, generator=generator)
        total = weighted_total(loss_dict)
        # NaN/Inf filtering as the JAX step has it (reference
        # tasks/trainer.py:632-639): the total is zeroed, but the gradient
        # of where(isfinite(t), t, 0) at a non-finite t is still
        # non-finite, so the update does not skip (ROADMAP.md Queue 3)
        safe_total = torch.where(torch.isfinite(total), total,
                                 torch.zeros_like(total))
        safe_total.backward()
        return {**{k: v.detach() for k, v in loss_dict.items()},
                "loss": total.detach()}

    def train_step(state: TrainState, batch, generator):
        params = state.params
        for p in params.values():
            p.grad = None
        if cfg.grad_accum > 1:
            seeds = torch.randint(0, 2 ** 62, (cfg.grad_accum,),
                                  generator=generator).tolist()
            metrics = None
            for i, seed in enumerate(seeds):
                m = micro_step({k: v[i] for k, v in batch.items()},
                               torch.Generator().manual_seed(seed))
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            metrics = {k: v / cfg.grad_accum for k, v in metrics.items()}
        else:
            metrics = micro_step(batch, generator)
        # a parameter the loss does not reach has a zero gradient, as in jax
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if cfg.grad_accum > 1:
            torch._foreach_mul_(list(grads.values()), 1.0 / cfg.grad_accum)
        metrics["grad_norm"] = tx.update(grads, state.opt_state, params)
        if anchor_params is not None and cfg.l2sp_rate > 0:
            with torch.no_grad():
                names = list(params)
                ps = [params[k] for k in names]
                anchors = [anchor_params[k] for k in names]
                torch._foreach_add_(ps, torch._foreach_sub(ps, anchors),
                                    alpha=-cfg.l2sp_rate)
                metrics["anchor_drift"] = global_norm(
                    torch._foreach_sub(ps, anchors))
        return TrainState(step=state.step + 1, params=params,
                          opt_state=state.opt_state), metrics

    return train_step


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


class Trainer:
    """The training loop: the host feeds batches, the device steps.

    ``model``: a RiporModel on the device to train on (its losses are
    LOSS_FNS[cfg.loss_type]); ``params``: the state_dict to start from,
    copied into the model. Periodic checkpointing + auto-resume mirror the
    reference trainer's save_steps / resume_from_checkpoint
    (tasks/trainer.py:186-200, 380-412, 521-544): pass a
    ``checkpoint_dir`` and an interrupted run restarts from the latest
    step (params + optimizer state + step count; already-consumed batches
    are skipped to preserve the data order)."""

    def __init__(self, model, cfg: TrainConfig, params,
                 mesh=None, log_fn=None,
                 checkpoint_dir: Optional[str] = None,
                 save_steps: int = 15_000, max_to_keep: int = 5,
                 eval_fn=None, eval_steps: int = 0, anchor_params=None):
        if mesh is not None or cfg.shard_opt_state:
            raise NotImplementedError(
                "Trainer(mesh=...) and shard_opt_state are not ported to "
                f"ripor_tpu_torch yet {_ITEM5}")
        if cfg.l2sp_rate > 0 and anchor_params is None:
            raise ValueError("l2sp_rate > 0 requires anchor_params")
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        model.load_state_dict(params)
        model.requires_grad_(True)
        self.tx = make_optimizer(cfg)
        named = dict(model.named_parameters())
        self.state = TrainState(step=0, params=named,
                                opt_state=self.tx.init(named))
        if anchor_params is not None:
            anchor_params = {k: torch.as_tensor(anchor_params[k]).to(
                self.device, p.dtype) for k, p in named.items()}
        self._step = make_train_step(model, cfg, self.tx,
                                     anchor_params=anchor_params)
        self.log_fn = log_fn or (lambda m, s: None)
        self.save_steps = save_steps
        # periodic in-training evaluation (reference CondDocID_DRTrainer
        # evaluate() on dev queries, tasks/trainer.py:870-977): eval_fn
        # receives the live params and returns a metrics dict that is
        # emitted as its own log record for the same step
        self.eval_fn = eval_fn
        self.eval_steps = eval_steps
        self._ckpt = None
        if checkpoint_dir is not None:
            from ripor_tpu_torch.train.checkpoint import CheckpointManager
            self._ckpt = CheckpointManager(checkpoint_dir, max_to_keep)
            latest = self._ckpt.latest_step()
            if latest is not None:
                self.load_state(self._ckpt.restore(latest))
        # resume point: pass start_batch=trainer.resume_step to the batch
        # functions (data/collators.py batches_from_*) so resume skips
        # consumed batches at the sampler-index level
        self.resume_step = self.state.step

    @torch.no_grad()
    def load_state(self, saved: Dict) -> None:
        """Take a saved state ({"step", "params", "opt_state"}, as
        CheckpointManager.restore returns it) into the model and the
        optimizer."""
        for k, p in self.state.params.items():
            p.copy_(saved["params"][k])
        opt = saved["opt_state"]
        self.state = TrainState(
            step=int(saved["step"]), params=self.state.params,
            opt_state={"count": int(opt["count"]), **{
                m: {k: opt[m][k].to(self.device, p.dtype).clone()
                    for k, p in self.state.params.items()}
                for m in ("mu", "nu")}})

    def run(self, batches, seed: int = 0, log_every: int = 100,
            flops_per_step: Optional[float] = None,
            batches_start: int = 0):
        """batches: iterable of fixed-shape batch dicts (numpy arrays or
        tensors). Pass ``flops_per_step`` (e.g. 6 * n_params *
        tokens_per_batch) to get MFU in the logs (utils/observability.py).

        ``batches_start``: global index of the first yielded batch (set it
        to the batch function's start_batch for fast resume). The dropout
        generator of step i is step_generator(seed, i), so resumed and
        uninterrupted runs draw the same masks however batches were
        fast-forwarded."""
        from ripor_tpu_torch.utils.observability import StepTimer
        timer = StepTimer(warmup=2, flops_per_step=flops_per_step,
                          device=self.device,
                          dtype=next(self.model.parameters()).dtype)
        metrics = None
        start_step = self.state.step
        for i, batch in enumerate(batches, start=batches_start):
            if i < start_step:      # fallback: iterable not fast-forwarded
                continue
            generator = step_generator(seed, i)
            with timer:
                self.state, metrics = self._step(
                    self.state, _to_device(batch, self.device), generator)
            step = self.state.step
            if step % log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host.update(timer.summary())
                self.log_fn(host, step)
            if (self.eval_fn is not None and self.eval_steps
                    and step % self.eval_steps == 0):
                self.log_fn(dict(self.eval_fn(self.state.params)), step)
            if self._ckpt is not None and step % self.save_steps == 0:
                self._ckpt.save(step, self.state)
        if (self._ckpt is not None and metrics is not None
                and self._ckpt.latest_step() != self.state.step):
            self._ckpt.save(self.state.step, self.state)
        return self.state, metrics
