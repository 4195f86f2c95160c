"""Trainer: the epoch loop with eval, best / latest checkpoints, early
stopping and resume (port of ``llm_in_practise_tpu/train/trainer.py``).

One device, one process: the model's own device (the card unless it
was built on the CPU). The step is the port's eager
:func:`~.step.make_train_step` (AdamW from :mod:`.optim` on a schedule of
:mod:`.schedules`); batches come from
:func:`~..data.loader.batch_iterator` with the epoch-seeded shuffle
(``DistributedSampler.set_epoch`` parity); training drops the ragged tail
batch and eval scores it. ``strategy="ddp"`` over a mesh of one device
runs; any larger mesh and every other strategy of the JAX package are
ROADMAP.md queue A item 14, and ``zero_offload`` (optimizer state in host
memory) item 13.

Checkpoints: ``ckpt_{step:08d}.msgpack`` (+ ``.json`` with the config)
holds ``step``, ``params`` (the flax GPT tree's names,
:func:`~..models.convert.gpt_params_to_jax`), ``opt_state`` (the port's
AdamW layout: ``count``, ``mini_step``, and ``mu`` / ``nu`` / ``acc``
trees under the same names) and ``rng`` (the dropout generator's state).
``best_model.msgpack`` holds the params alone, so the JAX package's
``restore_checkpoint`` and ``GPT.apply`` read it unchanged; the optimizer
state's layout is the port's own.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Iterable

import numpy as np
import torch

from llm_in_practise_tpu_torch.ckpt import checkpoint as ckpt_lib
from llm_in_practise_tpu_torch.core import config as config_lib
from llm_in_practise_tpu_torch.data.loader import batch_iterator
from llm_in_practise_tpu_torch.obs import (
    EpochTimer,
    RollingMean,
    Throughput,
    get_logger,
)
from llm_in_practise_tpu_torch.train import optim, schedules
from llm_in_practise_tpu_torch.train.step import (
    TrainState,
    make_dropout_loss,
    make_eval_step,
    make_train_step,
)

AUTO = config_lib.AUTO

# the JAX package's strategy names (parallel/strategy.py:357-368)
STRATEGIES = ("ddp", "zero1", "zero2", "zero3", "fsdp", "tp", "fsdp_tp", "ep",
              "sp", "zero_offload")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """TrainingArguments analog; JSON-loadable with file>CLI precedence."""

    # optimizer / schedule
    lr: float = 3e-4
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0
    grad_accum_steps: int = 1
    schedule: str = "constant"          # constant | cosine | step
    warmup_steps: int = 0
    total_steps: int | str = AUTO       # "auto" -> epochs * steps_per_epoch
    # loop
    epochs: int = 1
    batch_size: int = 8
    eval_every_steps: int = 0           # 0 = once per epoch
    log_every_steps: int = 50
    early_stop_patience: int = 0        # evals without improvement; 0 = off
    seed: int = 42
    # checkpointing: full state incl. optimizer + RNG, rotation, best
    ckpt_dir: str | None = None
    save_every_steps: int = 0           # 0 = once per epoch
    keep_checkpoints: int = 5
    resume: bool = True
    # parallelism
    strategy: str = "ddp"               # a name of STRATEGIES
    mesh_data: int = -1
    mesh_fsdp: int = 1
    mesh_model: int = 1
    mesh_expert: int = 1
    mesh_seq: int = 1
    allow_device_subset: bool = False

    @classmethod
    def from_sources(cls, *, config_file=None, cli_namespace=None, **auto):
        return config_lib.load(
            cls, config_file=config_file, cli_namespace=cli_namespace,
            auto_resolvers=auto or None,
        )


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported (ROADMAP.md queue A item {item})")


def check_strategy(cfg: TrainerConfig) -> bool:
    """Whether ``cfg`` offloads the optimizer state (``zero_offload``);
    raises for what one device cannot run: a strategy other than ``ddp``
    (item 14) or a mesh of more than one device."""
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; choose from "
                         f"{sorted(STRATEGIES)}")
    if cfg.strategy == "zero_offload":
        return True
    if cfg.strategy != "ddp":
        raise _not_ported(f"the {cfg.strategy!r} strategy (a sharded mesh)",
                          14)
    axes = {"mesh_fsdp": cfg.mesh_fsdp, "mesh_model": cfg.mesh_model,
            "mesh_expert": cfg.mesh_expert, "mesh_seq": cfg.mesh_seq}
    if cfg.mesh_data not in (-1, 1) or any(v != 1 for v in axes.values()):
        raise _not_ported(
            f"a mesh of more than one device (mesh_data={cfg.mesh_data}, "
            + ", ".join(f"{k}={v}" for k, v in axes.items()) + ")", 14)
    return False


class Trainer:
    """``Trainer(model, cfg).train((x, y), eval_data=(xv, yv))``.

    ``model``: a :class:`~..models.gpt.GPT`; ``params`` its initial
    state (names as in ``named_parameters``), default a fresh draw seeded
    by ``cfg.seed`` (:func:`~..models.gpt.init_params`).
    ``train_data`` / ``eval_data``: tuples of aligned host arrays
    (inputs, targets), or a callable ``epoch -> iterable of (x, y)``.
    ``loss_fn(model, batch) -> (loss, aux)`` defaults to next-token
    cross-entropy with dropout on (drawn from the trainer's generator);
    ``eval_loss_fn`` to the same with dropout off."""

    def __init__(self, model, cfg: TrainerConfig, *,
                 loss_fn: Callable | None = None,
                 eval_loss_fn: Callable | None = None,
                 strategy=None, metadata: dict | None = None,
                 callbacks: Iterable[Any] = (),
                 params: dict[str, torch.Tensor] | None = None):
        if strategy is not None:
            raise _not_ported("a Strategy object (sharded placement)", 14)
        self.model = model
        self.cfg = cfg
        self.metadata = metadata or {}
        self.callbacks = list(callbacks)
        self.log = get_logger("trainer")
        offload = check_strategy(cfg)
        self.device = model.device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.loss_fn = loss_fn or make_dropout_loss(self.generator)
        self.train_step = make_train_step(loss_fn=self.loss_fn,
                                          offload_opt=offload)
        self.eval_step = make_eval_step(loss_fn=eval_loss_fn)
        self._params = params
        self.names: list[str] = []
        self.state: TrainState | None = None
        self.history: list[dict] = []

    # --- state ---------------------------------------------------------------

    def _make_tx(self, steps_per_epoch: int) -> optim.AdamW:
        c = self.cfg
        total = c.total_steps
        if total == AUTO:
            if steps_per_epoch == 0 and c.schedule != "constant":
                raise ValueError(
                    f"schedule {c.schedule!r} needs total_steps, which cannot "
                    "be inferred from a callable data pipeline — set "
                    "TrainerConfig.total_steps explicitly")
            total = max(1, c.epochs * steps_per_epoch
                        // max(1, c.grad_accum_steps))
        lr = schedules.by_name(c.schedule, c.lr, total_steps=int(total),
                               warmup_steps=c.warmup_steps)
        return optim.adamw(lr, weight_decay=c.weight_decay,
                           clip_norm=c.clip_norm,
                           grad_accum_steps=c.grad_accum_steps)

    def _init_state(self, steps_per_epoch: int) -> TrainState:
        params = self._params
        if params is None:
            from llm_in_practise_tpu_torch.models.gpt import init_params

            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cfg.seed)
            params = init_params(self.model.cfg, gen, device=self.device)
        self.model.load_state({n: t.detach().to(self.device).clone()
                               for n, t in params.items()})
        self.names = [n for n, _ in self.model.named_parameters()]
        for p in self.model.parameters():
            p.requires_grad_(True)
        tx = self._make_tx(steps_per_epoch)
        tensors = [p for _, p in self.model.named_parameters()]
        state = TrainState(self.model, tensors, tx, tx.init(tensors))
        if self.cfg.resume and self.cfg.ckpt_dir:
            latest = ckpt_lib.latest_checkpoint(self.cfg.ckpt_dir)
            if latest:
                tree, _ = ckpt_lib.restore_checkpoint(latest)
                self._restore(state, tree)
                self.log.info("resumed from %s (step %d)", latest, state.step)
        return state

    def _to_tree(self, tensors) -> dict:
        from llm_in_practise_tpu_torch.models.convert import gpt_params_to_jax

        return gpt_params_to_jax(
            {n: t.detach() for n, t in zip(self.names, tensors)},
            self.model.cfg)

    def _from_tree(self, tree) -> list[torch.Tensor]:
        from llm_in_practise_tpu_torch.models.convert import (
            gpt_params_from_jax,
        )

        flat = gpt_params_from_jax(tree, self.model.cfg)
        return [flat[n] for n in self.names]

    def checkpoint_tree(self) -> dict:
        """The full training state as a tree of named leaves."""
        st = self.state
        opt = {k: v for k, v in st.opt_state.items()
               if not isinstance(v, list)}
        for k in ("mu", "nu", "acc"):
            if st.opt_state.get(k) is not None:
                opt[k] = self._to_tree(st.opt_state[k])
        return {"step": st.step, "params": self._to_tree(st.params),
                "opt_state": opt, "rng": self.generator.get_state()}

    @torch.no_grad()
    def _restore(self, state: TrainState, tree: dict) -> None:
        for p, v in zip(state.params, self._from_tree(tree["params"])):
            p.copy_(v)
        opt = tree["opt_state"]
        for k, v in opt.items():
            if isinstance(v, dict):
                for dst, src in zip(state.opt_state[k], self._from_tree(v)):
                    dst.copy_(src)
            elif v is not None:
                state.opt_state[k] = int(v)
        state.step = int(tree["step"])
        self.generator.set_state(tree["rng"])

    # --- loops ---------------------------------------------------------------

    def _batches(self, data, epoch: int, eval_mode: bool = False):
        if callable(data):
            yield from data(epoch)
            return
        yield from batch_iterator(
            tuple(np.asarray(a) for a in data),
            # eval scores every sample (incl. the tail batch); train drops
            # the ragged tail to keep step shapes static
            min(self.cfg.batch_size, len(data[0])) if eval_mode
            else self.cfg.batch_size,
            shuffle=not eval_mode, drop_last=not eval_mode,
            seed=self.cfg.seed, epoch=epoch)

    def _on_device(self, batch):
        return tuple(torch.as_tensor(np.asarray(a), device=self.device)
                     .long() for a in batch)

    def evaluate(self, eval_data) -> float:
        """Token-weighted mean eval loss over every sample, the tail batch
        included."""
        total, count = 0.0, 0.0
        for batch in self._batches(eval_data, epoch=0, eval_mode=True):
            batch = self._on_device(batch)
            m = self.eval_step(self.state, batch)
            n = float(m.get("n_valid", batch[0].numel()))
            total += float(m["loss"]) * n
            count += n
        return total / max(count, 1.0)

    def train(self, train_data, eval_data=None) -> list[dict]:
        c = self.cfg
        # peek one batch, then stitch it back so a one-shot callable
        # pipeline does not lose its first batch
        first_iter = iter(self._batches(train_data, epoch=0))
        first = next(first_iter)
        first_iter = itertools.chain([first], first_iter)
        steps_per_epoch = (len(train_data[0]) // c.batch_size
                           if not callable(train_data) else 0)
        if self.state is None:
            self.state = self._init_state(steps_per_epoch)

        best = float("inf")
        evals_since_best = 0
        rolling = RollingMean(50)
        meter = Throughput()
        stop = False
        start_epoch = (self.state.step // steps_per_epoch
                       if steps_per_epoch else 0)

        for epoch in range(start_epoch, c.epochs):
            timer = EpochTimer()
            epoch_losses = []
            batches = (first_iter if epoch == 0
                       else self._batches(train_data, epoch=epoch))
            for batch in batches:
                batch = self._on_device(batch)
                self.state, metrics = self.train_step(self.state, batch)
                step = self.state.step
                loss = float(metrics["loss"])
                epoch_losses.append(loss)
                rolling.update(loss)
                meter.step(int(batch[0].numel()))
                if c.log_every_steps and step % c.log_every_steps == 0:
                    self.log.info(
                        "epoch %d step %d | loss %.4f (last50 %.4f) | "
                        "%.0f tok/s", epoch + 1, step, loss, rolling.mean,
                        meter.tokens_per_sec)
                for cb in self.callbacks:
                    if hasattr(cb, "on_step"):
                        cb.on_step(self, step, metrics)
                if (c.eval_every_steps and step % c.eval_every_steps == 0
                        and eval_data is not None):
                    best, evals_since_best, stop = self._eval_and_track(
                        eval_data, best, evals_since_best)
                    if stop:
                        break
                if c.save_every_steps and step % c.save_every_steps == 0:
                    self._save(step)
            # a mid-epoch early stop falls through: the epoch record,
            # callbacks and final checkpoint below still run
            record = {
                "epoch": epoch + 1,
                "step": self.state.step,
                "train_loss": (float(np.mean(epoch_losses))
                               if epoch_losses else None),
                "time_s": timer.elapsed(),
                "tokens_per_sec": meter.tokens_per_sec,
            }
            if eval_data is not None and not c.eval_every_steps:
                best, evals_since_best, stop = self._eval_and_track(
                    eval_data, best, evals_since_best)
                record["eval_loss"] = self._last_eval
            self.history.append(record)
            self.log.info(
                "epoch %d/%d done | train %.4f%s | %.1fs", epoch + 1,
                c.epochs, record["train_loss"] or float("nan"),
                f" | eval {record.get('eval_loss'):.4f}"
                if record.get("eval_loss") is not None else "",
                record["time_s"])
            for cb in self.callbacks:
                if hasattr(cb, "on_epoch"):
                    cb.on_epoch(self, epoch, record)
            if not c.save_every_steps:
                self._save(self.state.step)
            if stop:
                self.log.info("early stopping (patience %d)",
                              c.early_stop_patience)
                break
        return self.history

    _last_eval: float | None = None

    def _eval_and_track(self, eval_data, best, since_best):
        loss = self.evaluate(eval_data)
        self._last_eval = loss
        if loss < best:
            best = loss
            since_best = 0
            if self.cfg.ckpt_dir:
                ckpt_lib.save_named(
                    self.cfg.ckpt_dir, self._to_tree(self.state.params),
                    "best_model",
                    metadata={**self.metadata, "eval_loss": loss,
                              "step": self.state.step})
        else:
            since_best += 1
        stop = (self.cfg.early_stop_patience > 0
                and since_best >= self.cfg.early_stop_patience)
        return best, since_best, stop

    def _save(self, step: int):
        if not self.cfg.ckpt_dir:
            return
        ckpt_lib.save_checkpoint(
            self.cfg.ckpt_dir, self.checkpoint_tree(), step,
            keep=self.cfg.keep_checkpoints,
            metadata={**self.metadata, "config": config_lib.to_dict(self.cfg)})

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The trained state (names as in ``named_parameters``), detached."""
        return {n: t.detach() for n, t in zip(self.names, self.state.params)}
