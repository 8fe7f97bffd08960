"""The train step and the epoch loop, on one device.

Port of ``pistoseg_tpu/train/loop.py`` (``make_train_step``:31-53 and
``Trainer``:72-201) without the mesh: multi-GPU comes with ROADMAP item
11.  What it keeps:

* a generator per step keyed by (seed, epoch, batch index), so a resumed
  run draws the same dropout masks as an uninterrupted one;
* the mid-epoch skip on resume (batch order is a pure function of
  (seed, epoch));
* one host sync per epoch, on the summed loss, plus one more after the
  first step of a run, which times the set-up that the first step pays
  (kernel build, cuDNN plans, allocator growth) apart from the rest;
* the epoch's log row: ``epoch``, ``train_loss``, ``steps``,
  ``epoch_seconds``, ``compile_seconds`` (that first step),
  ``step_ms_p50`` and ``items_per_sec`` (over the other steps);
* the end-of-epoch and every-N-steps checkpoint callbacks.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from pistoseg_tpu_torch.core.prng import stage_generator
from pistoseg_tpu_torch.train.state import TrainState

# loss_fn(model, batch, generator) -> (loss, metrics)
LossFn = Callable[[torch.nn.Module, Any, torch.Generator],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(loss_fn: LossFn):
    """One step: forward and loss, backward, optimizer update."""

    def step(state: TrainState, batch, generator: torch.Generator):
        loss, metrics = loss_fn(state.model, batch, generator)
        loss.backward()
        state.apply_gradients()
        return state, dict(metrics, loss=loss.detach())

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Epoch loop with end-of-epoch checkpoints and exact resume."""

    def __init__(
        self,
        train_step,
        epochs: int,
        train_iter_fn: Callable[[int], Iterable],
        seed: int,
        stream: str,
        device: torch.device,
        checkpoint_fn: Optional[Callable[[TrainState, int, float, bool], None]] = None,
        log_fn: Optional[Callable[[Dict], None]] = None,
        start_epoch: int = 0,
        start_step: int = 0,
        items_per_batch: Optional[int] = None,
        step_checkpoint_every: int = 0,
        step_checkpoint_fn: Optional[Callable[[TrainState, int, int], None]] = None,
    ):
        self.train_step = train_step
        self.epochs = epochs
        self.train_iter_fn = train_iter_fn
        self.seed = seed
        self.stream = stream            # the generators' name, e.g. "stage4/train"
        self.device = device
        self.checkpoint_fn = checkpoint_fn
        self.log_fn = log_fn or (lambda m: None)
        self.start_epoch = start_epoch
        self.start_step = start_step
        self.items_per_batch = items_per_batch
        self.step_checkpoint_every = step_checkpoint_every
        self.step_checkpoint_fn = step_checkpoint_fn

    def fit(self, state: TrainState) -> TrainState:
        first_step = True
        for epoch in range(self.start_epoch, self.epochs):
            t0 = time.perf_counter()
            compile_s = 0.0
            n_steps = 0
            loss_sum = None  # on the device: ONE fetch per epoch
            skip = self.start_step if epoch == self.start_epoch else 0
            for i, batch in enumerate(self.train_iter_fn(epoch)):
                if i < skip:
                    continue  # mid-epoch resume: batches already trained on
                # generator keyed by (epoch, batch index): identical on resume
                gen = stage_generator(self.seed, self.stream, epoch, i, self.device)
                t_step = time.perf_counter()
                state, metrics = self.train_step(state, batch, gen)
                loss = metrics["loss"]
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if first_step:
                    _sync(self.device)
                    compile_s = time.perf_counter() - t_step
                    first_step = False
                n_steps += 1
                if (self.step_checkpoint_every and self.step_checkpoint_fn
                        and (i + 1) % self.step_checkpoint_every == 0):
                    self.step_checkpoint_fn(state, epoch, i + 1)
            # the one host sync of the epoch: fetching the summed loss waits
            # for every step, so the wall clock below is honest
            train_loss = float(loss_sum) / n_steps if loss_sum is not None else float("nan")
            wall = time.perf_counter() - t0
            log = {
                "epoch": epoch,
                "train_loss": train_loss,
                "steps": n_steps,
                "epoch_seconds": wall,
                "compile_seconds": compile_s,
            }
            if skip and n_steps == 0:
                # the snapshot was taken after the epoch's last step: nothing
                # was trained here, so no train_loss is claimed
                log["resumed_skip"] = skip
            timed = n_steps - (1 if compile_s else 0)
            if timed > 0 and wall > compile_s:
                log["step_ms_p50"] = 1000.0 * (wall - compile_s) / timed
                if self.items_per_batch:
                    log["items_per_sec"] = self.items_per_batch * timed / (wall - compile_s)
            if self.checkpoint_fn is not None:
                self.checkpoint_fn(state, epoch, float("nan"), True)
            self.log_fn(log)
        return state
