"""The port's model, sampler and checkpoints held against the JAX package.

Parameters cross over through ``convert.params_from_jax``; token ids are made
with numpy and handed to both. Tolerances:
- f32 logits, atol 1e-4: the same operations, another summation order;
- bf16 compute, atol 2e-2: both round activations to bf16 at the same
  points, except that the port rounds the attention probabilities to bf16
  before P.V (the GPU kernels' rounding point) where the JAX package on the
  CPU keeps them in f32, so a logit can move by a few bf16 ulps;
- float64 against the reference model's fixture logits, atol 1e-10.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.models.sampler import generate_fast as jax_generate_fast
from trade_aid_multimodal_transformer_tpu.models.transformer import forward as jax_forward
from trade_aid_multimodal_transformer_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from trade_aid_multimodal_transformer_tpu.utils.torch_compat import convert_reference_state_dict
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import count_params, init_params, map_tree
from trade_aid_multimodal_transformer_tpu_torch.models.sampler import generate_fast
from trade_aid_multimodal_transformer_tpu_torch.models.transformer import forward, generate
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels
from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

FIXTURES = Path(__file__).parent / "fixtures"

CONFIGS = {
    # three modalities, two of them cross-attending, T in the kernel band
    "cross3": dict(vocab_sizes=(50, 20, 9), cross_attention=(True, False, True),
                   n_embd=32, n_head=2, n_layer=2, block_size=16),
    # one modality, no cross-attention, T below the band (dense cores only)
    "single": dict(vocab_sizes=(30,), cross_attention=(False,),
                   n_embd=24, n_head=3, n_layer=1, block_size=4),
    # every modality cross-attends
    "allcross": dict(vocab_sizes=(12, 7), cross_attention=(True, True),
                     n_embd=16, n_head=2, n_layer=3, block_size=8),
}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _pair(name, compute_dtype="float32", seed=0):
    kw = dict(CONFIGS[name], compute_dtype=compute_dtype)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _ids(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, (B, T)) for v in cfg.vocab_sizes]).astype(np.int32)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name, compute_dtype):
    jcfg, tcfg, jparams, tparams = _pair(name, compute_dtype)
    idx = _ids(tcfg, 3, tcfg.block_size, seed=1)
    jl, _ = jax_forward(jparams, jcfg, jnp.asarray(idx))
    tl, _ = forward(tparams, tcfg, torch.from_numpy(idx))
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL[compute_dtype], rtol=0)


def test_parameter_tree_matches_jax_layout():
    jcfg, tcfg, jparams, _ = _pair("cross3")
    ours = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jax_shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    our_shapes = map_tree(lambda t: tuple(t.shape), ours)
    assert our_shapes == jax_shapes
    assert count_params(ours) == sum(x.size for x in jax.tree_util.tree_leaves(jparams))


@pytest.mark.parametrize("name", ["model_parity", "model_parity_selective"])
def test_float64_reference_fixture(name):
    z = np.load(FIXTURES / f"{name}.npz")
    kw = dict(
        vocab_sizes=tuple(z["vocab_sizes"].tolist()),
        cross_attention=tuple(bool(c) for c in z["cross"]),
        n_embd=int(z["n_embd"]), n_head=int(z["n_head"]), n_layer=int(z["n_layer"]),
        block_size=int(z["block_size"]), dropout=0.0, attn_impl="jnp",
    )
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    with jax.enable_x64(True):
        tree = jax.tree.map(
            lambda a: np.asarray(a, np.float64), convert_reference_state_dict(sd, JaxConfig(**kw))
        )
    params = params_from_jax(tree, "cpu")
    cfg = ModelConfig(**kw)
    logits, _ = forward(params, cfg, torch.from_numpy(np.asarray(z["idx"])))
    for m in range(cfg.num_modalities):
        assert logits[m].dtype == torch.float64
        np.testing.assert_allclose(logits[m].numpy(), z[f"logits64_{m}"], atol=1e-10, rtol=0)


@pytest.mark.parametrize("leaf_dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_identically(tmp_path, leaf_dtype):
    jcfg, tcfg, jparams, _ = _pair("cross3", seed=3)
    if leaf_dtype == "bfloat16":
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    path = str(tmp_path / "model.ckpt")
    jax_save_checkpoint(path, jparams, step=7)
    ours, step = load_checkpoint(path, tcfg, "cpu")
    assert step == 7
    want = params_from_jax(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams), "cpu"
    )
    assert map_tree(lambda t: tuple(t.shape), ours) == map_tree(lambda t: tuple(t.shape), want)
    flat_got, flat_want = [], []
    map_tree(flat_got.append, ours)
    map_tree(flat_want.append, want)
    for a, b in zip(flat_got, flat_want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_port_checkpoint_loads_in_jax(tmp_path):
    jcfg, tcfg, jparams, _ = _pair("allcross")
    ours = init_params(tcfg, torch.Generator().manual_seed(5), "cpu")
    ours["blocks"][0]["sa"]["w1_q"] = ours["blocks"][0]["sa"]["w1_q"].bfloat16()
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, ours, step=3)
    back, _, step, _ = jax_load_checkpoint(path, jparams)
    assert step == 3
    flat_back = jax.tree_util.tree_leaves(back)
    flat_ours = []
    map_tree(flat_ours.append, ours)
    assert len(flat_back) == len(flat_ours)
    for a, b in zip(flat_back, flat_ours):
        np.testing.assert_array_equal(np.asarray(a), b.float().numpy())
    again, _ = load_checkpoint(path, tcfg, "cpu")
    flat_again = []
    map_tree(flat_again.append, again)
    for a, b in zip(flat_again, flat_ours):
        assert torch.equal(a, b.float())


def test_checkpoint_of_another_config_is_refused(tmp_path):
    _, tcfg, _, tparams = _pair("cross3")
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, tparams)
    other = ModelConfig(**dict(CONFIGS["cross3"], n_layer=3))
    with pytest.raises(KeyError):
        load_checkpoint(path, other, "cpu")
    wider = ModelConfig(**dict(CONFIGS["cross3"], vocab_sizes=(51, 20, 9)))
    with pytest.raises(ValueError):
        load_checkpoint(path, wider, "cpu")


@pytest.mark.parametrize("T0,steps", [(3, 20), (16, 5)])
def test_generate_fast_equals_step_by_step(T0, steps):
    _, tcfg, _, tparams = _pair("cross3", seed=2)
    idx = torch.from_numpy(_ids(tcfg, 2, T0, seed=4)).long()
    fast = generate_fast(tparams, tcfg, idx, torch.Generator().manual_seed(11), steps, 1)
    slow = generate(tparams, tcfg, list(idx), torch.Generator().manual_seed(11), steps, 1)
    assert torch.equal(fast, torch.stack(slow))
    assert fast.shape == (3, 2, T0 + steps)
    for m in (0, 2):  # other modalities repeat their last prompt token
        assert torch.all(fast[m, :, T0:] == idx[m, :, -1:])
    assert int(fast[1].max()) < tcfg.vocab_sizes[1]


def test_logits_along_a_jax_trajectory():
    """Token streams differ by RNG, so the logits are held instead: on every
    window of a JAX generate_fast trajectory, the port's last-position logits
    equal JAX forward's."""
    jcfg, tcfg, jparams, tparams = _pair("cross3", seed=6)
    T0, steps, mod = 10, 9, 0
    idx = _ids(tcfg, 2, T0, seed=8)
    traj = np.asarray(
        jax_generate_fast(jparams, jcfg, jnp.asarray(idx), jax.random.PRNGKey(1), steps, mod)
    )
    for s in range(steps):
        end = T0 + s
        win = np.array(traj[:, :, max(0, end - tcfg.block_size):end])
        jl, _ = jax_forward(jparams, jcfg, jnp.asarray(win))
        tl, _ = forward(tparams, tcfg, torch.from_numpy(win))
        np.testing.assert_allclose(
            tl[mod][:, -1].numpy(), np.asarray(jl[mod][:, -1]), atol=1e-4, rtol=0
        )


def test_cpu_forward_launches_no_kernel():
    _, tcfg, _, tparams = _pair("cross3")
    kernels.reset_launch_counts()
    forward(tparams, tcfg, torch.from_numpy(_ids(tcfg, 1, 16, seed=0)))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_training_forward_returns_losses_and_eval_forward_ignores_the_rng():
    """train=True with targets gives per-modality losses; without training
    the rng changes nothing (dropout is the identity)."""
    _, tcfg, _, tparams = _pair("single")
    tcfg = ModelConfig(**dict(CONFIGS["single"], dropout=0.3))
    idx = torch.from_numpy(_ids(tcfg, 2, 4, seed=3))
    logits, losses = forward(tparams, tcfg, idx, idx, rng=(1, 2), train=True)
    assert len(losses) == 1 and torch.isfinite(losses[0])
    a, _ = forward(tparams, tcfg, idx, rng=(1, 2))
    b, _ = forward(tparams, tcfg, idx)
    assert torch.equal(a[0], b[0])
    c, _ = forward(tparams, tcfg, idx, rng=(1, 2), train=True)
    assert not torch.equal(a[0], c[0])
