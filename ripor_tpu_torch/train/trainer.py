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
and on its device.

Data parallelism on a mesh (``Trainer(mesh=)``, ``jit_train_step``) is
SPMD: every rank passes the same global batch and trains on its 'data'
slice, and the params stay whole on every rank, as the JAX Trainer keeps
them. After the backward the gradients are averaged over the 'data' group
in a few flat buckets, so grad_norm, the clip and the update are the
same on every rank; the loss metrics are averaged likewise. Each of the
ten LOSS_FNS is a mean of per-example terms over the batch's rows (none
mixes rows: kldiv's softmax runs over each row's (pos, neg) pair, the
joint loss's seq2seq sub-batch is sliced with the rest), so over equal
slices the ranks' mean is the global batch's loss and gradient. With
``shard_opt_state`` (ZeRO) a rank keeps only its block of each Adam
moment (parallel/sharding.py::opt_moment_spec), updates that block of
the param from the averaged gradient and all-gathers the blocks: the
replicated update, element for element.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ripor_tpu_torch.core.mesh import (DATA_AXIS, _via_host,
                                       all_gather_cat, all_reduce_sum,
                                       axis_size, barrier, is_first_process)
from ripor_tpu_torch.parallel.sharding import (DataSlice, block_index,
                                               local_block,
                                               opt_state_pspec_tree,
                                               shard_batch)
from ripor_tpu_torch.train import losses as loss_lib

# the most elements a bucket of the gradient mean, of the update and of
# the ZeRO all-gather takes
GRAD_BUCKET = 1 << 25


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
    # ZeRO-style: split Adam mu/nu over the mesh 'data' axis (read only
    # with a mesh, as in the JAX package)
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
               params: Dict[str, torch.Tensor],
               zero: Optional["DataParallel"] = None) -> torch.Tensor:
        """Apply one update to ``params`` and ``opt_state`` in place;
        returns the global norm of ``grads`` (before clipping). The update
        runs a bucket of params at a time (``_buckets``), so its
        temporaries are one bucket's. ``zero``: the moments are this
        rank's ZeRO blocks; the update runs on the matching blocks of
        params and grads, and every rank's blocks of a bucket are gathered
        into the whole params before the next bucket."""
        names = list(params)
        g_norm = global_norm([grads[k] for k in names])
        scale = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                            self.max_norm / g_norm)
        b1, b2 = self.b1, self.b2
        lr = self.schedule(opt_state["count"])
        opt_state["count"] += 1
        n = opt_state["count"]
        for idx in _buckets([params[k] for k in names]):
            bucket = [names[i] for i in idx]
            if zero is None:
                ps = [params[k] for k in bucket]
                gs = [grads[k] for k in bucket]
            else:
                ps = [zero.local(k, params[k]) for k in bucket]
                gs = [zero.local(k, grads[k]) for k in bucket]
            mus = [opt_state["mu"][k] for k in bucket]
            nus = [opt_state["nu"][k] for k in bucket]
            gs = torch._foreach_mul(gs, scale)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, gs, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
            del gs
            denom = torch._foreach_div(nus, 1 - b2 ** n)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mus, 1 - b1 ** n)
            torch._foreach_div_(upd, denom)
            del denom
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
            torch._foreach_add_(ps, upd, alpha=-lr)
            del upd
            if zero is not None:
                zero.gather_into(params, dict(zip(bucket, ps)))
        return g_norm


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(cfg)


def step_generator(seed: int, step: int, data_index: int = 0
                   ) -> torch.Generator:
    """The dropout generator of step ``step``, a function of (seed, step)
    alone, as the JAX trainer's fold_in(rng, step): a resumed run draws
    what an uninterrupted one does. On a mesh, data rank ``data_index``
    draws masks of its own from (seed, step, data_index) (the first data
    rank draws the one-process masks); model-axis peers, which see the
    same rows, draw the same masks, so their params stay equal."""
    entropy = [seed, step] + ([data_index] if data_index else [])
    s = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(s[0]))


def _buckets(tensors, cap: Optional[int] = None):
    """Runs of indices into ``tensors``, each run of one dtype and at
    most ``cap`` (None: GRAD_BUCKET) elements, or one larger tensor."""
    cap = GRAD_BUCKET if cap is None else cap
    out, cur, n = [], [], 0
    for i, t in enumerate(tensors):
        if cur and (n + t.numel() > cap
                    or t.dtype != tensors[cur[0]].dtype):
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += t.numel()
    return out + [cur] if cur else out


class DataParallel:
    """The collectives of data-parallel training on ``mesh``: the mean of
    gradients and metrics over the 'data' group, and with ``zero_specs``
    (each param's moment spec, opt_state_pspec_tree's "mu") the ZeRO
    blocks and their all-gather over the world. ``collective_s``: host
    seconds spent in these collectives (on a gloo group with CUDA
    tensors, where each goes through host copies, the card is synced
    first, so they are the collectives' wall time)."""

    def __init__(self, mesh, zero_specs: Optional[Dict] = None):
        self.mesh = mesh
        self.group = mesh.get_group(DATA_AXIS)
        self.n = axis_size(mesh, DATA_AXIS)
        self.zero = zero_specs
        self.collective_s = 0.0

    def _timed(self, fn, x, group):
        sync = _via_host(x, group)
        if sync:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize(x.device)
        self.collective_s += time.perf_counter() - t0
        return out

    @torch.no_grad()
    def average(self, tensors) -> None:
        """Each tensor, in place, its mean over the 'data' group: one
        all-reduce a bucket of flattened tensors."""
        if self.n == 1:
            return
        for idx in _buckets(tensors):
            bucket = [tensors[i] for i in idx]
            flat = torch.cat([t.reshape(-1) for t in bucket])
            self._timed(lambda: all_reduce_sum(flat, self.group), flat,
                        self.group)
            flat.div_(self.n)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def average_metrics(self, metrics: Dict) -> Dict:
        names = sorted(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k]).float()
                            for k in names])
        self.average([vals])
        return dict(zip(names, vals.unbind()))

    def local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x`` by its moment spec (``x`` itself
        where the moment replicates)."""
        spec = self.zero[name]
        return local_block(x, spec, self.mesh) if any(spec) else x

    @torch.no_grad()
    def gather_into(self, full: Dict[str, torch.Tensor],
                    blocks: Dict[str, torch.Tensor]) -> None:
        """Every rank's ``blocks`` written into the whole tensors
        ``full`` (by name): one all-gather over the world a bucket of
        blocks (``_buckets``), each rank's blocks of the bucket one flat
        buffer padded to the longest rank's."""
        names = [k for k in blocks if any(self.zero[k])]
        if not names or self.mesh.size() == 1:
            for k in names:
                full[k].copy_(blocks[k])
            return
        grid = self.mesh.mesh.tolist()       # [data][model] -> rank
        axes = self.mesh.mesh_dim_names
        coords = {r: dict(zip(axes, (d, m)))
                  for d, row in enumerate(grid) for m, r in enumerate(row)}
        for idx in _buckets([blocks[k] for k in names]):
            ks = [names[i] for i in idx]
            slices = {r: [block_index(full[k].shape, self.zero[k], self.mesh,
                                      c) for k in ks]
                      for r, c in coords.items()}
            sizes = {r: [full[k][sl].numel() for k, sl in zip(ks, s)]
                     for r, s in slices.items()}
            width = max(sum(v) for v in sizes.values())
            pad = width - sum(blocks[k].numel() for k in ks)
            flat = torch.cat([blocks[k].reshape(-1) for k in ks]
                             + [blocks[ks[0]].new_zeros(pad)])
            every = self._timed(lambda: all_gather_cat(flat, None), flat,
                                None)
            del flat
            for r in range(len(coords)):
                off = r * width
                for k, sl, n in zip(ks, slices[r], sizes[r]):
                    dst = full[k][sl]
                    dst.copy_(every[off:off + n].view(dst.shape))
                    off += n
            del every

    def whole_moments(self, opt_state: Dict,
                      params: Dict[str, torch.Tensor]) -> Dict:
        """The optimizer state with every rank's moment blocks gathered
        into whole moments (for a checkpoint)."""
        out = {"count": opt_state["count"]}
        for m in ("mu", "nu"):
            whole = {k: (torch.empty_like(p) if any(self.zero[k])
                         else opt_state[m][k]) for k, p in params.items()}
            self.gather_into(whole, opt_state[m])
            out[m] = whole
        return out


def make_train_step(model, cfg: TrainConfig, tx: AdamW,
                    anchor_params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Callable:
    """The train step: (state, batch, generator, dp=None) -> (state,
    metrics), the update applied in place. With cfg.grad_accum > 1 the
    batch tensors have a leading accumulation axis [accum, micro_bz, ...];
    gradients and metrics are averaged over the micro-batches, each with a
    generator of its own drawn from ``generator``. ``dp``: a
    DataParallel (``jit_train_step``): the step trains on this rank's
    'data' slice of the batch (the micro-batch dim with grad_accum > 1)
    and averages gradients and metrics over the data group."""
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

    def train_step(state: TrainState, batch, generator,
                   dp: Optional[DataParallel] = None):
        if dp is not None:
            batch = shard_batch(batch, dp.mesh,
                                dim=1 if cfg.grad_accum > 1 else 0)
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
        if dp is not None:
            dp.average(list(grads.values()))
            metrics = dp.average_metrics(metrics)
        metrics["grad_norm"] = tx.update(
            grads, state.opt_state, params,
            zero=dp if dp is not None and dp.zero is not None else None)
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


def jit_train_step(train_step: Callable, mesh,
                   opt_specs: Optional[Dict] = None) -> Callable:
    """The JAX ``jit_train_step``'s counterpart: ``train_step`` (from
    make_train_step) run data-parallel on ``mesh`` — each rank's 'data'
    slice of the global batch, the gradient mean over the data group and,
    with ``opt_specs`` (opt_state_pspec_tree of a state sharded by
    parallel/sharding.py::shard_opt_state), the ZeRO update. Nothing is
    compiled. The returned step's ``dp`` is its DataParallel."""
    dp = DataParallel(mesh, None if opt_specs is None else opt_specs["mu"])

    def step(state, batch, generator):
        return train_step(state, batch, generator, dp=dp)
    step.dp = dp
    return step


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(v).to(device, non_blocking=True)
           for k, v in batch.items()}
    return DataSlice(out) if isinstance(batch, DataSlice) else out


class Trainer:
    """The training loop: the host feeds batches, the device steps.

    ``model``: a RiporModel on the device to train on (its losses are
    LOSS_FNS[cfg.loss_type]); ``params``: the state_dict to start from,
    copied into the model. Periodic checkpointing + auto-resume mirror the
    reference trainer's save_steps / resume_from_checkpoint
    (tasks/trainer.py:186-200, 380-412, 521-544): pass a
    ``checkpoint_dir`` and an interrupted run restarts from the latest
    step (params + optimizer state + step count; already-consumed batches
    are skipped to preserve the data order).

    ``mesh``: train data-parallel (module docstring): every rank builds
    the Trainer with the same params and runs the same global batches;
    with ``cfg.shard_opt_state`` Adam's moments are ZeRO blocks. On a mesh
    the first rank alone writes checkpoints, a ZeRO state gathered to
    whole moments first (so a mesh checkpoint and a one-process one load
    in each other), and every rank restores from them."""

    def __init__(self, model, cfg: TrainConfig, params,
                 mesh=None, log_fn=None,
                 checkpoint_dir: Optional[str] = None,
                 save_steps: int = 15_000, max_to_keep: int = 5,
                 eval_fn=None, eval_steps: int = 0, anchor_params=None):
        if cfg.l2sp_rate > 0 and anchor_params is None:
            raise ValueError("l2sp_rate > 0 requires anchor_params")
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        model.load_state_dict(params)
        model.requires_grad_(True)
        self.tx = make_optimizer(cfg)
        self.mesh = mesh
        named = dict(model.named_parameters())
        self._zero = None
        if mesh is not None and cfg.shard_opt_state:
            self._zero = opt_state_pspec_tree({"mu": named}, named)
            opt_state = {"count": 0, **{m: {
                k: local_block(torch.zeros_like(p), self._zero["mu"][k],
                               mesh) for k, p in named.items()}
                for m in ("mu", "nu")}}
        else:
            opt_state = self.tx.init(named)
        self.state = TrainState(step=0, params=named, opt_state=opt_state)
        if anchor_params is not None:
            anchor_params = {k: torch.as_tensor(anchor_params[k]).to(
                self.device, p.dtype) for k, p in named.items()}
        step = make_train_step(model, cfg, self.tx,
                               anchor_params=anchor_params)
        self._step = (step if mesh is None
                      else jit_train_step(step, mesh, self._zero))
        self.log_fn = log_fn or (lambda m, s: None)
        self.save_steps = save_steps
        # periodic in-training evaluation (reference CondDocID_DRTrainer
        # evaluate() on dev queries, tasks/trainer.py:870-977): eval_fn
        # receives the live params and returns a metrics dict that is
        # emitted as its own log record for the same step
        self.eval_fn = eval_fn
        self.eval_steps = eval_steps
        self._ckpt = None
        self._saved_step = None
        if checkpoint_dir is not None:
            from ripor_tpu_torch.train.checkpoint import CheckpointManager
            self._ckpt = CheckpointManager(checkpoint_dir, max_to_keep)
            latest = self._ckpt.latest_step()
            if latest is not None:
                self.load_state(self._ckpt.restore(latest))
                self._saved_step = latest
        # resume point: pass start_batch=trainer.resume_step to the batch
        # functions (data/collators.py batches_from_*) so resume skips
        # consumed batches at the sampler-index level
        self.resume_step = self.state.step

    @property
    def dp(self) -> Optional[DataParallel]:
        """The mesh step's DataParallel (None without a mesh)."""
        return getattr(self._step, "dp", None)

    @torch.no_grad()
    def load_state(self, saved: Dict) -> None:
        """Take a saved state ({"step", "params", "opt_state"}, as
        CheckpointManager.restore returns it, moments whole) into the
        model and the optimizer; with ZeRO each rank keeps its blocks."""
        for k, p in self.state.params.items():
            p.copy_(saved["params"][k])
        opt = saved["opt_state"]

        def moment(m, k, p):
            x = opt[m][k].to(self.device, p.dtype)
            if self._zero is not None:
                return local_block(x, self._zero["mu"][k], self.mesh)
            return x.clone()
        self.state = TrainState(
            step=int(saved["step"]), params=self.state.params,
            opt_state={"count": int(opt["count"]), **{
                m: {k: moment(m, k, p)
                    for k, p in self.state.params.items()}
                for m in ("mu", "nu")}})

    def whole_state(self) -> TrainState:
        """The state with whole Adam moments (gathered from every rank's
        ZeRO blocks: a collective on the mesh)."""
        if self._zero is None:
            return self.state
        return TrainState(step=self.state.step, params=self.state.params,
                          opt_state=self.dp.whole_moments(
                              self.state.opt_state, self.state.params))

    def save(self) -> None:
        """Checkpoint the state at its step (on a mesh every rank calls
        it; the first rank writes)."""
        state = self.whole_state()
        if self.mesh is None or is_first_process():
            self._ckpt.save(state.step, state)
        if self.mesh is not None:
            barrier()
        self._saved_step = state.step

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
                          dtype=next(self.model.parameters()).dtype,
                          n_devices=(self.mesh.size() if self.mesh is not None
                                     else 1))
        data_index = (0 if self.mesh is None
                      else self.mesh.get_local_rank(DATA_AXIS))
        metrics = None
        start_step = self.state.step
        for i, batch in enumerate(batches, start=batches_start):
            if i < start_step:      # fallback: iterable not fast-forwarded
                continue
            generator = step_generator(seed, i, data_index)
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
                self.save()
        if (self._ckpt is not None and metrics is not None
                and self._saved_step != self.state.step):
            self.save()
        return self.state, metrics
