"""What each rank process of the port's context-parallel tests runs.

The tests (tests/test_torch_ring.py) start these functions in spawned
processes joined in one gloo group (``parallel.mesh.run_ranks``); a child
imports this module, torch and the port, never JAX: the JAX references are
computed in the test process.
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
    mesh = pmesh.seq_mesh(world)
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
    trainer = make_sharded_trainer(cfg, None, opt, [], 1, pmesh.seq_mesh(world))
    as_batch = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    loss, grads = trainer.loss_and_grads(params, [as_batch[0]], [salts[0]])
    state = opt.init(params)
    losses = [trainer.step(params, state, [b], [s]).item() for b, s in zip(as_batch, salts)]
    return (loss.item(), [g.numpy() for g in grads], losses,
            [np.asarray(p.detach().numpy()) for p in tree_leaves(params)])
