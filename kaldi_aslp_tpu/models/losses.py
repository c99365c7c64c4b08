"""Training losses: Xent / Mse / MultiTask / CTC.

JAX-native equivalents of the reference loss layer (reference:
src/aslp-nnet/nnet-loss.h:35 LossItf, nnet-loss.cc:63 Xent::Eval,
:205 Mse, nnet-loss.h:173 MultiTaskLoss, ctc-loss.{h,cc}).

Each loss is a pure function (logits, targets, weights) → (scalar mean
loss, aux dict) usable under jit/grad, plus a host-side accumulator class
that reproduces the reference's progress reporting — including the
"AvgLoss: ... FRAME_ACCURACY >> x% <<" line format the scheduler scripts
parse (reference: nnet-loss.cc:179-196)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_aslp_tpu.ops.ctc import ctc_loss


def xent_loss(
    logits: jnp.ndarray,       # [..., V]
    targets: jnp.ndarray,      # [...] int labels
    weights: Optional[jnp.ndarray] = None,  # [...] frame weights
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Weighted cross-entropy + frame accuracy (reference: nnet-loss.cc:63)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    picked = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    if weights is None:
        weights = jnp.ones_like(picked)
    total_w = jnp.maximum(weights.sum(), 1e-8)
    loss = -(picked * weights).sum() / total_w
    correct = (jnp.argmax(logits, axis=-1) == targets).astype(jnp.float32)
    acc = (correct * weights).sum() / total_w
    return loss, {"frames": total_w, "accuracy": acc,
                  "loss_sum": -(picked * weights).sum()}


def mse_loss(
    output: jnp.ndarray, targets: jnp.ndarray,
    weights: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """(reference: nnet-loss.cc:205 Mse::Eval)."""
    diff = output - targets
    per_frame = 0.5 * jnp.sum(diff * diff, axis=-1)
    if weights is None:
        weights = jnp.ones_like(per_frame)
    total_w = jnp.maximum(weights.sum(), 1e-8)
    loss = (per_frame * weights).sum() / total_w
    return loss, {"frames": total_w, "loss_sum": (per_frame * weights).sum()}


@dataclass
class MultiTaskSpec:
    """Parsed from "multitask,xent,2456,1.0,mse,440,0.001"
    (reference: nnet-loss.h:173 InitFromString, documented in
    aslp-nnetbin/aslp-nnet-train-simple.cc:150-157)."""

    kinds: List[str] = field(default_factory=list)
    dims: List[int] = field(default_factory=list)
    scales: List[float] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "MultiTaskSpec":
        toks = spec.split(",")
        if toks[0] != "multitask":
            raise ValueError(f"bad multitask spec {spec!r}")
        out = cls()
        for i in range(1, len(toks), 3):
            out.kinds.append(toks[i])
            out.dims.append(int(toks[i + 1]))
            out.scales.append(float(toks[i + 2]))
        return out


def multitask_loss(
    spec: MultiTaskSpec,
    logits: jnp.ndarray,               # [..., sum(dims)]
    targets: jnp.ndarray,              # [...] int labels OR [..., D] dense
    weights: Optional[jnp.ndarray] = None,
):
    """Column-blocked multi-objective loss (reference: nnet-loss.h:173).

    Integer targets index each task's block independently; dense targets
    are sliced per block for mse tasks."""
    total = 0.0
    aux: Dict[str, jnp.ndarray] = {}
    off = 0
    for k, (kind, dim, scale) in enumerate(
        zip(spec.kinds, spec.dims, spec.scales)
    ):
        block = logits[..., off:off + dim]
        if kind == "xent":
            li, ai = xent_loss(block, targets[..., k] if targets.ndim >
                               block.ndim - 1 else targets, weights)
            aux[f"task{k}_acc"] = ai["accuracy"]
        elif kind == "mse":
            li, ai = mse_loss(block, targets[..., off:off + dim], weights)
        else:
            raise ValueError(f"unknown multitask objective {kind!r}")
        total = total + scale * li
        aux[f"task{k}_loss"] = li
        off += dim
    return total, aux


def ctc_batch_loss(
    logits: jnp.ndarray,         # [S, T, V]
    labels: jnp.ndarray,         # [S, U]
    input_lengths: jnp.ndarray,  # [S]
    label_lengths: jnp.ndarray,  # [S]
    blank: int = 0,
    recursion=None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Mean per-frame CTC objective (reference: ctc-loss.cc:115).
    ``recursion``: see ops/ctc.py ``ctc_alpha_beta``."""
    nll = ctc_loss(logits, labels, input_lengths, label_lengths, blank,
                   recursion)
    frames = jnp.maximum(input_lengths.sum(), 1)
    return nll.sum() / frames, {
        "per_seq_nll": nll,
        "frames": frames.astype(jnp.float32),
        "loss_sum": nll.sum(),
    }


def ctc_loss_spike_mask(
    per_seq_nll: np.ndarray, input_lengths: np.ndarray,
    mode: str = "avg", threshold: float = 10.0,
) -> np.ndarray:
    """Bad-minibatch detection (reference: ctc-loss.h:32-36
    SUM/AVG/NONE_LOSS_CHECK, skip logic ctc-loss.cc:229-344).

    Returns a boolean keep-mask over sequences; 'avg' drops sequences
    whose per-frame loss exceeds threshold x the batch median."""
    if mode == "none":
        return np.ones(len(per_seq_nll), bool)
    per_frame = np.asarray(per_seq_nll) / np.maximum(
        np.asarray(input_lengths), 1
    )
    if mode == "sum":
        return np.isfinite(per_frame) & (per_frame < threshold)
    med = np.median(per_frame[np.isfinite(per_frame)]) if np.isfinite(
        per_frame
    ).any() else 0.0
    return np.isfinite(per_frame) & (
        per_frame < max(threshold * max(med, 1e-3), threshold)
    )


class LossReporter:
    """Host-side progress accumulator printing reference-compatible lines
    (reference: nnet-loss.cc:179-196 Xent::Report)."""

    # 1h of 10ms frames between ProgressLoss lines, like the reference
    PROGRESS_STEP = 3600 * 100

    # keep this many batches' device scalars un-fetched: fetching a
    # value is a synchronous round trip that would serialize the train
    # loop; by the time a batch is MAX_PENDING old its step has long
    # finished, so the deferred fetch costs one round trip per drain
    # instead of one per batch
    MAX_PENDING = 64

    def __init__(self, name: str = "xent",
                 progress_step: int = PROGRESS_STEP):
        self.name = name
        self._loss_sum = 0.0
        self._frames = 0.0
        self._correct = 0.0
        self._pending: List[Dict[str, jnp.ndarray]] = []
        self._progress: List[float] = []
        self._progress_step = progress_step
        self._frames_progress = 0.0
        self._loss_progress = 0.0

    def update(self, aux: Dict[str, jnp.ndarray]) -> None:
        """Record one batch's aux scalars WITHOUT fetching them — the
        device values are drained lazily (see MAX_PENDING)."""
        self._pending.append(aux)
        if len(self._pending) >= self.MAX_PENDING:
            self._drain()

    def _drain(self) -> None:
        pending, self._pending = self._pending, []
        if not pending:
            return
        # one stacked fetch per key, not one round trip per batch
        cols: Dict[str, np.ndarray] = {}
        for k in ("frames", "loss_sum", "accuracy"):
            vals = [aux.get(k) for aux in pending]
            if all(v is None for v in vals):
                continue
            filled = [jnp.asarray(0.0 if v is None else v,
                                  jnp.float32) for v in vals]
            cols[k] = np.asarray(jnp.stack(filled))
        for i, aux in enumerate(pending):
            f = float(cols["frames"][i])
            loss = float(cols["loss_sum"][i]) if "loss_sum" in aux else 0.0
            self._loss_sum += loss
            self._frames += f
            if "accuracy" in aux:
                self._correct += float(cols["accuracy"][i]) * f
            if self._frames > 0:
                self._progress.append(self._loss_sum / self._frames)
            # progressive loss line every progress_step frames, last-field
            # parsable by aslp-log-analyse (reference: nnet-loss.cc:135-153
            # "ProgressLoss[last Nh of Mh]: ...")
            self._frames_progress += f
            self._loss_progress += loss
            if self._frames_progress > self._progress_step:
                from kaldi_aslp_tpu.utils.log import get_logger
                get_logger("nnet-loss").info(
                    "ProgressLoss[last %dh of %dh]: (%s) %.6f",
                    int(self._frames_progress / self._progress_step),
                    int(self._frames / self._progress_step),
                    self.name,
                    self._loss_progress / self._frames_progress)
                self._frames_progress = 0.0
                self._loss_progress = 0.0

    @property
    def frames(self) -> float:
        self._drain()
        return self._frames

    @property
    def loss_sum(self) -> float:
        self._drain()
        return self._loss_sum

    @property
    def correct(self) -> float:
        self._drain()
        return self._correct

    @property
    def avg_loss(self) -> float:
        self._drain()
        return self._loss_sum / max(self._frames, 1.0)

    @property
    def frame_accuracy(self) -> float:
        return 100.0 * self.correct / max(self.frames, 1.0)

    def report(self) -> str:
        out = (f"AvgLoss: {self.avg_loss:.4f} ({self.name}), "
               f"[frames {int(self.frames)}]")
        if self.correct > 0:
            out += f"\nFRAME_ACCURACY >> {self.frame_accuracy:.4f}% <<"
        return out
