"""The JAX package's sharded trainer's step on a CPU mesh, for
tests/test_torch_combos.py: importable alone (JAX, numpy and the JAX
package; no torch), so that the test's spawned processes compute these
steps without importing the test module.
"""

import math
import os
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as PS

from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.parallel import make_mesh as jax_make_mesh
from trade_aid_multimodal_transformer_tpu.parallel.trainer import (
    make_sharded_trainer as jax_make_sharded_trainer, shard_train_state as jax_shard_train_state)
from trade_aid_multimodal_transformer_tpu.train.steps import make_optimizer as jax_make_optimizer
from trade_aid_multimodal_transformer_tpu.utils.memory import train_state_bytes as jax_state_bytes

B, MU = 4, 2
KEY = (2718281828, 3141592653)
# XLA's CPU backend with its LLVM passes cut: about half the compile time of a step here (the
# same HLO program; its floating-point results may differ in the last bits, within the bounds)
FAST_COMPILE = " --xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"


def fast_compile():
    """A spawned process's initializer: compile with ``FAST_COMPILE``
    (read when JAX first initializes its backend, after this)."""
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + FAST_COMPILE


def init(model, seed: int = 7):
    """The JAX package's init of ``model`` (a ModelConfig's keywords but
    dropout) under one ``jit``."""
    jcfg = JaxConfig(**dict(model, dropout=0.0))
    return jax.jit(lambda k: jax_init(k, jcfg))(jax.random.PRNGKey(seed))


def batch(model, seed: int = 8):
    """One global (M, B, T) batch of inputs and targets, int32, seeded."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, (B, model["block_size"] + 1))
                    for v in model["vocab_sizes"]])
    return ids[..., :-1].astype(np.int32), ids[..., 1:].astype(np.int32)


def _per_device(arr, n: int):
    """A JAX array's value on each of the first n devices."""
    shards = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    return [shards[d.id] for d in jax.devices()[:n]]


def step(jparams, model, rate, mesh, fsdp, xy, place0=False):
    """The JAX package's sharded trainer's step on ``mesh`` (CPU devices)
    on the global batch ``xy`` with the raw key ``KEY``: per device (in
    mesh order) the loss, every gradient leaf's shard (placed as its
    parameter) and the placed parameters' shards, which leaves it
    replicates, and the train-state bytes of its ``shard_train_state``.
    ``place0``: the model axis's index read as 0 on every device while the
    step traces (the ring's key fold)."""
    jcfg = JaxConfig(**dict(model, dropout=rate))
    n = math.prod(mesh.values())
    jmesh = jax_make_mesh(mesh.get("data", 1), mesh.get("model", 1), jax.devices()[:n],
                          seq=mesh.get("seq", 1), mod=mesh.get("mod", 1), pipe=mesh.get("pipe", 1))
    opt = jax_make_optimizer(1e-3)
    p_sh, o_sh = jax_shard_train_state(jparams, opt, jmesh, jcfg.n_head,
                                       model_axis=mesh.get("model", 1) > 1, fsdp=fsdp)
    trainer = jax_make_sharded_trainer(jcfg, None, opt, [], 1, jmesh, pipeline_microbatches=MU)
    # the gradients placed as the parameters, so that a device's shard is its part
    shardings = (NamedSharding(jmesh, PS()), jax.tree.map(lambda a: a.sharding, p_sh))

    @partial(jax.jit, out_shardings=shardings)
    def run(p, xb, yb, k):
        with trainer.scope():
            xb, yb = trainer.batch_constraint(xb), trainer.batch_constraint(yb)
            (loss, _), g = jax.value_and_grad(trainer.loss_fn, has_aux=True)(
                p, jcfg, xb, yb, k, True)
        return loss, g

    real = jax.lax.axis_index
    if place0:
        jax.lax.axis_index = lambda name: jnp.int32(0) if name == "model" else real(name)
    try:
        loss, grads = run(p_sh, jnp.asarray(xy[0]), jnp.asarray(xy[1]),
                          jnp.asarray(KEY, jnp.uint32))
    finally:
        jax.lax.axis_index = real
    return {"loss": [float(x) for x in _per_device(loss, n)],
            "grads": [_per_device(g, n) for g in jax.tree.leaves(grads)],
            "parts": [_per_device(p, n) for p in jax.tree.leaves(p_sh)],
            "replicated": [p.sharding.is_fully_replicated for p in jax.tree.leaves(p_sh)],
            "bytes": jax_state_bytes(p_sh, o_sh)}


def case(params, model, rate, mesh, fsdp, place0=False):
    """``step`` of a case from the tree ``params`` (numpy leaves in the JAX
    tree's structure) and the seeded batch (a process may run several in
    turn: the JAX package's context-parallel scope is a module global, so
    one process traces one step at a time)."""
    return step(jax.tree.map(jnp.asarray, params), model, rate, mesh, fsdp, batch(model), place0)
