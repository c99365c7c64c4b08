"""Newbob learning-rate scheduling with accept/reject and resume markers.

JAX-native equivalent of the reference's bash epoch controller
(reference: aslp_scripts/aslp_nnet/train_scheduler.sh:100-180 — per-epoch
train, CV loss, accept/reject against the best model, LR halving gated by
start/end improvement thresholds, resume from .learn_rate/.halving/
.done_iterN marker files)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class NewbobOptions(Config):
    max_iters: int = 20
    min_iters: int = 0
    keep_lr_iters: int = 0
    start_halving_impr: float = 0.01
    end_halving_impr: float = 0.001
    halving_factor: float = 0.5


@dataclasses.dataclass
class NewbobState:
    iter: int = 0
    learn_rate: float = 0.008
    halving: bool = False
    best_cv_loss: float = float("inf")
    done: bool = False


class NewbobScheduler:
    """Drives the accept/reject + halving protocol; persists state to
    ``<dir>/newbob_state.json`` so interrupted training resumes exactly
    (the marker-file behavior of train_scheduler.sh:73-96)."""

    def __init__(self, work_dir: str, initial_lr: float,
                 opts: Optional[NewbobOptions] = None):
        self.opts = opts or NewbobOptions()
        self.dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.state = NewbobState(learn_rate=initial_lr)
        self._state_path = os.path.join(work_dir, "newbob_state.json")
        if os.path.exists(self._state_path):
            with open(self._state_path) as f:
                self.state = NewbobState(**json.load(f))

    def save(self) -> None:
        with open(self._state_path, "w") as f:
            json.dump(dataclasses.asdict(self.state), f)

    @property
    def best_model_path(self) -> str:
        return os.path.join(self.dir, "nnet_best.knet")

    def epoch_model_path(self, cv_loss: float) -> str:
        s = self.state
        return os.path.join(
            self.dir,
            f"nnet_iter{s.iter:02d}_lr{s.learn_rate:g}_cv{cv_loss:.4f}.knet",
        )

    def report(self, cv_loss: float, hold: bool = False) -> bool:
        """Report this epoch's CV loss; returns True if the epoch is
        ACCEPTED (model should become the new best), False if rejected
        (caller reloads the previous best — train_scheduler.sh:134-148).

        ``hold=True`` is the dynamic form of keep_lr_iters: the epoch
        is force-accepted, no halving-state transitions happen, and the
        improvement baseline tracks the CURRENT loss (so newbob's
        rel-impr restarts cleanly when the caller releases the hold).
        Used by the CTC saddle detector (train/saddle.py): while greedy
        output is still (near-)all-blank, rejecting an epoch or halving
        the lr strands the model on the blank-collapse saddle — the
        generic-robustness role of the reference's CTC loss-check/skip
        machinery (src/aslp-nnet/ctc-loss.cc:229-344)."""
        s = self.state
        if hold:
            s.best_cv_loss = cv_loss
            s.iter += 1
            if s.iter >= self.opts.max_iters:
                s.done = True
            self.save()
            return True
        accepted = cv_loss < s.best_cv_loss
        rel_impr = ((s.best_cv_loss - cv_loss)
                    / abs(s.best_cv_loss)
                    if s.best_cv_loss not in (0.0, float("inf")) else 1.0)
        if accepted:
            s.best_cv_loss = cv_loss
        s.iter += 1
        if s.iter >= self.opts.max_iters:
            s.done = True
        if s.iter > self.opts.keep_lr_iters:
            if s.halving:
                s.learn_rate *= self.opts.halving_factor
                if (rel_impr < self.opts.end_halving_impr
                        and s.iter > self.opts.min_iters):
                    s.done = True
            elif rel_impr < self.opts.start_halving_impr:
                s.halving = True
                s.learn_rate *= self.opts.halving_factor
        self.save()
        return accepted

    def set_learn_rate(self, lr: float) -> None:
        """Externally adjust the lr (saddle-escalation); persisted so a
        resumed run keeps the escalated rate."""
        self.state.learn_rate = lr
        self.save()

    @property
    def done(self) -> bool:
        return self.state.done

    @property
    def learn_rate(self) -> float:
        return self.state.learn_rate
