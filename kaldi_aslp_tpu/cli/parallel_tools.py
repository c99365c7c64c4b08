"""Data-parallel trainer worker CLIs.

JAX-native equivalents of the reference MPI worker binaries
(reference: src/aslp-parallelbin/aslp-nnet-train-frame-worker.cc,
aslp-nnet-train-lstm-stream-worker.cc:126-189 — worker selected by
--worker-type, params synced every --sync-period frames;
aslp-nnet-train-server.cc runs the parameter-server side).

Here the MPI ranks become devices of a jax mesh in ONE process:
  bsp  — gradient psum every step over the 'data' axis (bsp-worker.cc
         model averaging, sync_period = minibatch)
  bmuf — local SGD inside blocks + block-momentum sync across a
         ('block','data') mesh every --sync-period frames
         (bmuf-worker.cc:37-68)
  sod  — psum'd delta consumed by a server-side optax optimizer
         (sod-worker.cc + optimizer.h), the server role fused into the
         collective.
  easgd/asgd/masgd — asynchronous parameter-server modes re-expressed
         as deterministic-schedule rounds (parallel/ps.py): local SGD
         per worker row on a ('worker',) mesh, then the server's
         one-at-a-time sync loop as a sequential scan in arrival order
         (easgd-server.cc:38-61).  The server role is fused into the
         same program — aslp-nnet-train-server explains."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from kaldi_aslp_tpu.utils.config import Config, parse_options
from kaldi_aslp_tpu.utils.log import get_logger

logger = get_logger("parallel-cli")


@dataclasses.dataclass
class WorkerFlags(Config):
    worker_type: str = "bsp"     # bsp | bmuf | sod | easgd | asgd | masgd
    num_workers: int = 0         # 0 = all local devices
    sync_period: int = 25600     # frames between syncs (ref default)
    learn_rate: float = 0.008
    momentum: float = 0.0
    bmuf_momentum: float = 0.9
    bmuf_learn_rate: float = 1.0
    server_optimizer: str = "sgd"   # sod server-side optimizer
    alpha: float = -1.0          # easgd/asgd gain; -1 = per-mode ref
    #                              default (easgd 0.5, asgd/masgd 1.0)
    masgd_momentum: float = 0.9  # masgd server momentum
    masgd_type: str = "local"    # local (LMASGD) | global (GMASGD)
    minibatch_size: int = 256
    cross_validate: bool = False


def nnet_train_worker(argv):
    """Frame-CE data-parallel worker (reference:
    aslp-nnet-train-frame-worker.cc / aslp-nnet-train-lstm-stream-
    worker.cc roles; one process drives all devices instead of one MPI
    rank per GPU)."""
    import jax
    import jax.numpy as jnp

    from kaldi_aslp_tpu.data.randomizer import (
        FrameRandomizer,
        RandomizerOptions,
    )
    from kaldi_aslp_tpu.models import Nnet
    from kaldi_aslp_tpu.models.losses import LossReporter, xent_loss
    from kaldi_aslp_tpu.parallel import (
        BmufOptions,
        make_bmuf_block_step,
        make_bsp_train_step,
        make_mesh,
        make_optimizer,
        OptimizerOptions,
        shard_batch,
        stack_block_states,
    )
    from kaldi_aslp_tpu.train import (
        NnetTrainOptions,
        init_velocity,
        make_sgd_update,
    )
    from kaldi_aslp_tpu.cli.train_tools import _source

    flags = WorkerFlags()
    ropts = RandomizerOptions()
    args = parse_options(
        argv, [flags, ropts],
        "aslp-nnet-train-*-worker --worker-type=bsp|bmuf|sod "
        "feats-rspec targets-rspec model-in [model-out]",
        3, 4,
    )
    ropts.minibatch_size = flags.minibatch_size

    n = flags.num_workers or len(jax.devices())
    devices = jax.devices()[:n]
    net, params, model_states = Nnet.load(args[2])
    opts = NnetTrainOptions(learn_rate=flags.learn_rate,
                            momentum=flags.momentum)

    def loss_fn(p, batch):
        # frame batch [B, D] as a length-1 "sequence" per frame
        y, _ = net.apply(p, batch["feats"][:, None, :], train=True)
        return xent_loss(y, batch["targets"][:, None],
                         jnp.ones(batch["targets"].shape + (1,),
                                  jnp.float32))

    reporter = LossReporter("xent")
    lr = jnp.asarray(flags.learn_rate, jnp.float32)

    def batches():
        r = FrameRandomizer(ropts)
        for _, f, t in _source(args[0], args[1]):
            r.feed(f, t)
            if r.full():
                yield from r.iterate_minibatches()
        yield from r.flush()

    def pad_to(f, t, mult):
        m = len(t)
        if m % mult == 0:
            return f, t
        pad = mult - m % mult
        return (np.concatenate([f, f[:pad]]),
                np.concatenate([t, t[:pad]]))

    if flags.worker_type in ("easgd", "asgd", "masgd"):
        from kaldi_aslp_tpu.parallel import (
            PsOptions,
            PsState,
            make_ps_round_step,
            ps_sync_round,
            stack_worker_states,
        )

        alpha = flags.alpha
        if alpha < 0:
            alpha = 0.5 if flags.worker_type == "easgd" else 1.0
        mesh = make_mesh(("worker",), devices=devices)
        update = make_sgd_update(net, opts)
        inner = max(1, flags.sync_period // max(flags.minibatch_size, 1))
        ps_opts = PsOptions(mode=flags.worker_type, alpha=alpha,
                            masgd_momentum=flags.masgd_momentum,
                            masgd_type=flags.masgd_type)
        step = make_ps_round_step(loss_fn, update, mesh, ps_opts,
                                  inner_steps=inner, scan_batches=True)
        state = PsState(params, n, ps_opts)
        opt_states = stack_worker_states(init_velocity(params), n)
        from jax.sharding import NamedSharding, PartitionSpec as P
        sharding = NamedSharding(mesh, P(None, "worker"))
        pend_f, pend_t = [], []
        for f, t in batches():
            f, t = pad_to(f, t, n)
            pend_f.append(f[:len(f) // n * n])
            pend_t.append(t[:len(t) // n * n])
            if len(pend_f) < inner:
                continue
            b = min(len(x) for x in pend_t)
            batch = {
                "feats": jax.device_put(
                    jnp.asarray(np.stack([x[:b] for x in pend_f])),
                    sharding),
                "targets": jax.device_put(
                    jnp.asarray(np.stack(
                        [x[:b].astype(np.int32) for x in pend_t])),
                    sharding),
            }
            pend_f, pend_t = [], []
            state.workers, opt_states, loss = step(
                state.workers, opt_states, batch, lr)
            state = ps_sync_round(state)
            reporter.update({"frames": inner * b,
                             "loss_sum": float(loss) * inner * b})
        params = state.server  # the server model is the product
    elif flags.worker_type == "bmuf":
        if n < 2:
            logger.warning("bmuf with <2 workers degenerates to SGD")
        mesh = make_mesh(("block", "data"), devices=devices,
                         shape=(n, 1))
        update = make_sgd_update(net, opts)
        # fresh minibatches between syncs: sync_period frames / global
        # minibatch (reference default 25600 → 100 minibatches of 256)
        inner = max(1, flags.sync_period // max(flags.minibatch_size, 1))
        step = make_bmuf_block_step(
            loss_fn, update, mesh,
            BmufOptions(bmuf_momentum=flags.bmuf_momentum,
                        bmuf_learn_rate=flags.bmuf_learn_rate),
            inner_steps=inner, scan_batches=True,
        )
        w_prev = params
        delta = jax.tree_util.tree_map(jnp.zeros_like, params)
        opt_blk = stack_block_states(init_velocity(params), n)
        from jax.sharding import NamedSharding, PartitionSpec as P
        sharding = NamedSharding(mesh, P(None, ("block", "data")))
        pend_f, pend_t = [], []
        for f, t in batches():
            f, t = pad_to(f, t, n)
            pend_f.append(f[:len(f) // n * n])
            pend_t.append(t[:len(t) // n * n])
            if len(pend_f) < inner:
                continue
            b = min(len(x) for x in pend_t)
            batch = {
                "feats": jax.device_put(
                    jnp.asarray(np.stack([x[:b] for x in pend_f])),
                    sharding),
                "targets": jax.device_put(
                    jnp.asarray(np.stack(
                        [x[:b].astype(np.int32) for x in pend_t])),
                    sharding),
            }
            pend_f, pend_t = [], []
            params, w_prev, delta, opt_blk, loss = step(
                params, w_prev, delta, opt_blk, batch, lr)
            reporter.update({"frames": inner * b,
                             "loss_sum": float(loss) * inner * b})
    else:
        mesh = make_mesh(("data",), devices=devices)
        if flags.worker_type == "sod":
            import optax

            opt = make_optimizer(OptimizerOptions(
                optimizer=flags.server_optimizer,
                learn_rate=flags.learn_rate))

            def update(p, g, s, lr_):
                updates, s = opt.update(g, s, p)
                return optax.apply_updates(p, updates), s
            opt_state = opt.init(params)
        else:
            update = make_sgd_update(net, opts)
            opt_state = init_velocity(params)
        step = make_bsp_train_step(loss_fn, update, mesh)
        for f, t in batches():
            f, t = pad_to(f, t, n)
            batch = shard_batch(
                {"feats": jnp.asarray(f),
                 "targets": jnp.asarray(t.astype(np.int32))}, mesh)
            params, opt_state, loss, aux = step(
                params, opt_state, batch, lr)
            # aux is pmean'd across shards → rescale counts to global
            reporter.update({
                "frames": float(aux["frames"]) * n,
                "loss_sum": float(aux["loss_sum"]) * n,
                "accuracy": float(aux["accuracy"]),
            })

    if len(args) > 3 and not flags.cross_validate:
        net.save(args[3], params, model_states)
    print(reporter.report())
    logger.info("worker-type=%s over %d devices done",
                flags.worker_type, n)
    return 0


def nnet_train_server(argv):
    """Parameter-server role (reference: aslp-nnet-train-server.cc for
    easgd/asgd/masgd).  Here the server is fused into the worker
    program: synchronous modes need no server (psum IS the server), and
    the asynchronous modes run their server sync loop as a sequential
    scan inside the worker step (parallel/ps.py)."""
    parse_options(argv, [], "aslp-nnet-train-server", 0, None)
    print(
        "aslp-nnet-train-server: no separate server process — "
        "the server role is fused into the worker program.\n"
        "  bsp/sod          -> the psum collective is the server "
        "(aslp-nnet-train-*-worker --worker-type=bsp|sod)\n"
        "  bmuf             -> block sync inside the worker "
        "(--worker-type=bmuf)\n"
        "  easgd/asgd/masgd -> the server's one-at-a-time sync loop "
        "runs as a sequential scan in the worker step "
        "(--worker-type=easgd|asgd|masgd; parallel/ps.py)",
        file=sys.stderr,
    )
    return 0
