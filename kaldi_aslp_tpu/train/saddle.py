"""Automatic CTC blank-saddle crossing.

CTC training passes through an all-blank saddle: the loss plateaus
while the model emits blank at every frame, then label peaks emerge
and the loss drops.  Newbob's default halving terminates mid-saddle at
an all-blank model, and the saddle's depth scales with the label
inventory (measured: a 40-phone inventory crosses at lr 0.06 in
~700-1100 steps; a ~200-unit syllable inventory never crosses at 0.06
but crosses at lr 0.2 in ~500 steps).  Hand-tuning keep_lr_iters and
the lr per corpus is what the round-3 recipes did; this module replaces
that with a detector so every recipe runs the SAME schedule policy.

The saddle signature is BOTH of:
  * greedy output >= ``blank_thresh`` all-blank, AND
  * cv loss no longer improving (rel-impr < ``impr_thresh`` — the same
    threshold newbob uses to start halving).

While the signature holds, epochs are reported to newbob with
``hold=True`` (force-accept, no halving, no done-by-improvement), and
after ``escalate_iters`` consecutive held epochs the lr is multiplied
by ``lr_factor`` (capped at ``max_lr``) — the adaptive form of "this
inventory needs a hotter start".  While the loss is still falling, the
detector stays out of the way even if output is all-blank: newbob
cannot halve during healthy improvement anyway, and escalating a
working lr bakes the model at a too-hot rate (measured on a toy task:
blind escalation to 0.8 converged the loss but left the model greedy
all-blank forever).  Once greedy output crosses below the threshold
the detector retires and newbob runs untouched.

Reference role: the generic robustness machinery around CTC training in
src/aslp-nnet/ctc-loss.cc:229-344 (loss-check modes that detect and
skip divergent minibatches) — the reference detects pathology inside
the loss; here the pathological regime is the all-blank saddle and
the detector manages the lr schedule across it."""

from __future__ import annotations

import dataclasses

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.utils.log import get_logger

logger = get_logger("saddle")


@dataclasses.dataclass
class SaddleOptions(Config):
    enabled: bool = True
    blank_thresh: float = 0.90   # greedy blank fraction >= this = blank
    impr_thresh: float = 0.01    # rel cv-loss improvement below this =
    #                              plateau (newbob's start_halving_impr)
    escalate_iters: int = 4      # held epochs before lr escalation
    lr_factor: float = 2.0
    max_lr: float = 0.8


class SaddleDetector:
    """Tracks greedy blank fraction + cv-loss progress across epochs;
    drives newbob holds and lr escalation.  Call
    ``update(blank_frac, cv_loss, sched)`` once per epoch BEFORE
    ``sched.report``; pass the returned bool as ``hold``."""

    def __init__(self, opts: SaddleOptions | None = None):
        self.opts = opts or SaddleOptions()
        self._prev_loss: float | None = None
        self._held_streak = 0
        self.crossed = False
        self.saddle_epochs = 0

    def update(self, blank_frac: float, cv_loss: float, sched) -> bool:
        opts = self.opts
        if not opts.enabled or self.crossed:
            self._prev_loss = cv_loss
            return False
        if blank_frac < opts.blank_thresh:
            self.crossed = True
            logger.info("saddle crossed after %d held epochs "
                        "(blank %.1f%%, lr %.4f)", self.saddle_epochs,
                        100 * blank_frac, sched.learn_rate)
            self._prev_loss = cv_loss
            return False
        rel_impr = 1.0
        if self._prev_loss is not None and self._prev_loss != 0.0:
            rel_impr = (self._prev_loss - cv_loss) / abs(self._prev_loss)
        self._prev_loss = cv_loss
        if rel_impr >= opts.impr_thresh:
            # all-blank but still descending: newbob cannot halve during
            # healthy improvement, so no hold (and no escalation) needed
            self._held_streak = 0
            return False
        # the saddle proper: all-blank AND plateaued
        self.saddle_epochs += 1
        self._held_streak += 1
        if self._held_streak >= opts.escalate_iters:
            new_lr = min(sched.learn_rate * opts.lr_factor, opts.max_lr)
            if new_lr > sched.learn_rate:
                logger.info("saddle: %d plateaued all-blank epochs — "
                            "lr %.4f -> %.4f", self._held_streak,
                            sched.learn_rate, new_lr)
                sched.set_learn_rate(new_lr)
            self._held_streak = 0
        return True
