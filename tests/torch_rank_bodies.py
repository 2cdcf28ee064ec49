"""What each rank process of the port's parallel tests runs.

The tests (tests/test_torch_ring.py, tests/test_torch_dp.py) start these
functions in spawned processes joined in one gloo group
(``parallel.mesh.run_ranks``); a child imports this module, torch and the
port, never JAX: the JAX references are computed in the test process.
"""

import numpy as np
import torch

from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.ring_attention import (
    ring_causal_attention,
)
from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import make_sharded_trainer
from trade_aid_multimodal_transformer_tpu_torch.train.steps import make_optimizer


def ring_cases(rank, world, cases):
    """Each case (q, k, v, g, impl, rate, salts): the whole output of ring
    attention over the group and the gradients of q, k, v for output
    gradient g, as numpy."""
    torch.set_num_threads(1)  # no thread split to vary with the machine's load: the same bits
    mesh = pmesh.make_mesh(seq=world).seq
    out = []
    for q, k, v, g, impl, rate, salts in cases:
        q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
        o = ring_causal_attention(q, k, v, mesh, impl, rate, salts, rate > 0)
        grads = torch.autograd.grad(o, (q, k, v), g)
        out.append([o.detach().numpy()] + [x.numpy() for x in grads])
    return out


def cp_training(rank, world, cfg_kw, params, batches, salts, opt_kw):
    """The context-parallel Trainer over the group: the loss and gradients
    of one step at ``params`` (batches[0], salts[0]), then a trajectory of
    one step per batch. Returns (loss, grads, losses, final params) as numpy."""
    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    cfg = ModelConfig(**cfg_kw)
    # the ranks receive the parent's tensors in shared memory: each updates its own copy
    params = map_tree(lambda t: t.detach().clone().requires_grad_(), params)
    opt = make_optimizer(1e-3, **opt_kw)
    trainer = make_sharded_trainer(cfg, None, opt, [], 1, pmesh.make_mesh(seq=world))
    as_batch = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    loss, grads = trainer.loss_and_grads(params, [as_batch[0]], [salts[0]])
    state = opt.init(params)
    losses = [trainer.step(params, state, [b], [s]).item() for b, s in zip(as_batch, salts)]
    return (loss.item(), [g.numpy() for g in grads], losses,
            [np.asarray(p.detach().numpy()) for p in tree_leaves(params)])


def _dp_feed(job):
    from trade_aid_multimodal_transformer_tpu_torch.sampling.feed import BatchFeed
    from trade_aid_multimodal_transformer_tpu_torch.train.metrics import build_metric_specs

    f = job["feed"]
    feed = BatchFeed(f["train"], f["val"], f["file_lengths"], job["cfg"]["block_size"],
                     job["batch"], False, f["rand_sizes"], list(job["cfg"]["vocab_sizes"]))
    return feed, build_metric_specs(f["vocabs"], [False] * len(f["vocabs"]),
                                    job["cfg"]["block_size"])


def dp_cases(rank, world, job):
    """One rank of a data-parallel run (``make_mesh(data=world)``, or data x
    seq with ``job["seq"]``): the loss and gradients of one step of the
    data-parallel Trainer on the global batch ``job["batches"][0]``; with
    ``job["steps"]`` a trajectory of one step per batch (losses and final
    parameters); with ``job["feed"]`` an evaluation pass of the global
    validation batches and one step of ``make_shard_map_dp_step``. Every
    result as numpy. ``job["kernel_dispatch"]`` takes the card's dispatch
    with the kernels' plain versions (the whole-row band's fused and cross
    kernels)."""
    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import make_shard_map_dp_step
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng

    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    if job.get("kernel_dispatch"):
        tatt._kernel_device = lambda device, impl: impl != "jnp"
    seq = job.get("seq", 1)
    mesh = pmesh.make_mesh(data=world // seq, seq=seq)
    cfg = ModelConfig(**job["cfg"])
    fresh = lambda: map_tree(lambda t: t.detach().clone().requires_grad_(), job["params"])  # noqa: E731
    feed, specs = _dp_feed(job) if "feed" in job else (None, [])
    opt = make_optimizer(1e-3)
    trainer = make_sharded_trainer(cfg, feed, opt, specs, job.get("eval_iters", 1), mesh)
    as_batch = [tuple(torch.from_numpy(a) for a in b) for b in job["batches"]]
    params = fresh()
    loss, grads = trainer.loss_and_grads(params, [as_batch[0]], [job["salts"][0]])
    out = {"loss": loss.item(), "grads": [g.numpy() for g in grads]}
    if job.get("steps"):
        state = opt.init(params)
        out["losses"] = [trainer.step(params, state, [b], [s]).item()
                         for b, s in zip(as_batch, job["salts"])]
        out["params"] = [p.detach().numpy().copy() for p in tree_leaves(params)]
    if feed is not None:
        ev = trainer.eval_pass(fresh(), StepRng(job["seed"], "cpu"), "val")
        out["eval"] = {k: v.numpy() for k, v in ev._asdict().items()}
        params = fresh()
        state = opt.init(params)
        step = make_shard_map_dp_step(cfg, feed, opt, mesh.data)
        out["dp_step_loss"] = step(params, state, job["seed"]).item()
        out["dp_step_params"] = [p.detach().numpy().copy() for p in tree_leaves(params)]
    return out
