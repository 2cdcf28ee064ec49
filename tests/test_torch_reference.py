"""The reference model's checkpoints and the rest of its API in the port,
held against the JAX package on the CPU.

- ``utils/torch_compat.py``: the converted tree equals the JAX package's
  leaf for leaf (f64, exact) on both reference fixtures; a ``.pth`` written
  from a fixture's state_dict loads with f64 logits within 1e-10 of the
  reference model's (the f64 forward agrees to ~6e-16, as
  tests/test_model_parity.py pins it); the loaders read it as weights only.
- The training and generation entries on a ``.pth`` equal the ``.npz``
  path exactly (the same weights, the same seeds).
- ``training_flops_per_step``, ``generate_batch_starting_indices``, the
  config accessors and the experimental pieces: exact, as
  tests/test_reference_api_parity.py holds the JAX package's.
"""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trade_aid_multimodal_transformer_tpu.config import compat as jax_compat
from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.experimental import long_tanh as jax_long_tanh
from trade_aid_multimodal_transformer_tpu.models.param_count import (
    training_flops_per_step as jax_training_flops,
)
from trade_aid_multimodal_transformer_tpu.sampling.indices import (
    generate_batch_starting_indices as jax_starting_indices,
)
from trade_aid_multimodal_transformer_tpu.utils.torch_compat import (
    convert_reference_state_dict as jax_convert,
)
from trade_aid_multimodal_transformer_tpu_torch import generate
from trade_aid_multimodal_transformer_tpu_torch.config import compat as port_compat
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.experimental import (
    fixed_embedding_lookup,
    long_tanh,
    make_fixed_embedding_table,
)
from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params, map_tree, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.models.param_count import training_flops_per_step
from trade_aid_multimodal_transformer_tpu_torch.models.transformer import forward
from trade_aid_multimodal_transformer_tpu_torch.sampling import (
    SplitIndexPlan,
    generate_batch_starting_indices,
)
from trade_aid_multimodal_transformer_tpu_torch.train import runner
from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_optimizer_state,
    save_checkpoint,
)
from trade_aid_multimodal_transformer_tpu_torch.train.steps import make_optimizer
from trade_aid_multimodal_transformer_tpu_torch.utils.torch_compat import (
    convert_reference_state_dict,
    load_reference_checkpoint,
    reference_state_dict,
)

from test_torch_host import write_stock_folder  # noqa: E402  (tests/ is on the path)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "fixtures"
NAMES = ["model_parity", "model_parity_selective"]


def _fixture(name):
    z = np.load(FIXTURES / f"{name}.npz")
    kw = dict(vocab_sizes=tuple(z["vocab_sizes"].tolist()),
              cross_attention=tuple(bool(c) for c in z["cross"]),
              n_embd=int(z["n_embd"]), n_head=int(z["n_head"]), n_layer=int(z["n_layer"]),
              block_size=int(z["block_size"]), dropout=0.0, attn_impl="jnp")
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    return z, kw, sd


# ------------------------------------------------------------ .pth checkpoints


@pytest.mark.parametrize("name", NAMES)
def test_converted_tree_equals_jax_and_inverts(name):
    """The port's tree of a reference state_dict equals the JAX package's
    leaf for leaf (f64), and ``reference_state_dict`` gives back the
    state_dict's parameters exactly."""
    _, kw, sd = _fixture(name)
    ours = convert_reference_state_dict(sd, ModelConfig(**kw))
    with jax.enable_x64(True):
        ref = jax.tree.map(np.asarray, jax_convert(sd, JaxConfig(**kw)))
    assert map_tree(lambda t: tuple(t.shape), ours) == jax.tree.map(lambda a: a.shape, ref)
    for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(ref), strict=True):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), b)
    back = reference_state_dict(ours, ModelConfig(**kw))
    params = {k: v for k, v in sd.items() if not k.endswith("tril")}
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_pth_fixture_loads_with_reference_logits(tmp_path, name):
    """A fixture's state_dict saved with ``torch.save``: its f64 logits within
    1e-10 of the reference model's; ``load_checkpoint`` reads it as f32
    weights with no step, ``load_optimizer_state`` finds no moments."""
    z, kw, sd = _fixture(name)
    path = tmp_path / "model.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    cfg = ModelConfig(**kw)
    params = load_reference_checkpoint(str(path), cfg)
    logits, _ = forward(params, cfg, torch.from_numpy(z["idx"]))
    for m in range(cfg.num_modalities):
        assert logits[m].dtype == torch.float64
        np.testing.assert_allclose(logits[m].numpy(), z[f"logits64_{m}"], atol=1e-10, rtol=0)
    f32, step = load_checkpoint(str(path), cfg, "cpu")
    assert step is None
    for a, b in zip(tree_leaves(f32), tree_leaves(params), strict=True):
        assert a.dtype == torch.float32 and torch.equal(a, b.float())
    assert load_optimizer_state(str(path), f32, make_optimizer(1e-3)) is None
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(path), ModelConfig(**{**kw, "block_size": kw["block_size"] * 2}), "cpu")


@pytest.fixture
def demo_dir(tmp_path, monkeypatch):
    """The demo config on the CPU with 4 steps, a weights-only ``.npz`` and
    the same weights as a reference ``.pth`` beside it."""
    text = (REPO / "examples" / "demo_config.yaml").read_text()
    text = text.replace("max_iters: 50", "max_iters: 4").replace("eval_interval: 25",
                                                                 "eval_interval: 2\n  eval_iters: 2")
    text = text.replace("device: auto", "device: cpu")
    (tmp_path / "config.yaml").write_text(text)
    shutil.copy(REPO / "examples" / "demo_input_schemas.yaml", tmp_path / "input_schemas.yaml")
    (tmp_path / "examples" / "demo_data").mkdir(parents=True)
    shutil.copy(REPO / "examples" / "demo_data" / "demo_stock.csv",
                tmp_path / "examples" / "demo_data" / "demo_stock.csv")
    port_compat.reset_compatibility_layer()
    cfg = generate.load_config_and_data(str(tmp_path))["cfg"]
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    save_checkpoint(str(tmp_path / "model.npz"), params)
    torch.save(reference_state_dict(params, cfg), tmp_path / "model.pth")
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    port_compat.reset_compatibility_layer()


def test_generate_serves_a_pth_as_its_npz(demo_dir):
    runs = [generate.run(str(demo_dir), tokens=5, seed=3, checkpoint=str(demo_dir / f"model.{ext}"))
            for ext in ("npz", "pth")]
    np.testing.assert_array_equal(runs[0]["new"], runs[1]["new"])
    assert runs[1]["model"] == f"checkpoint {demo_dir / 'model.pth'}"


def test_run_training_resumes_from_a_pth_as_from_its_npz(demo_dir, capsys):
    """``create_new_model: 0`` on the ``.pth``: the loaded line, a fresh
    optimizer, and the same run as from the weights-only ``.npz``."""
    text = (demo_dir / "config.yaml").read_text()
    results = []
    for ext in ("npz", "pth"):
        (demo_dir / "config.yaml").write_text(text.replace(
            'model_file_name: "output/demo_model.ckpt"', f'model_file_name: "model.{ext}"').replace(
            "create_new_model: 1", "create_new_model: 0"))
        port_compat.reset_compatibility_layer()
        res = runner.run_training(caller_globals={}, seed=0)
        out = capsys.readouterr().out
        assert "Model: Loaded successfully" in out and "Optimizer: Created with loaded parameters" in out
        assert res["opt_state"]["count"] == 4
        results.append((res, [re.sub(r"\d\d:\d\d:\d\d", "#", line) for line in out.splitlines()]))
    (a, out_a), (b, out_b) = results
    assert out_a == [line.replace("model.pth", "model.npz") for line in out_b]
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"]), strict=True):
        assert torch.equal(x, y)


# ------------------------------------------------------------ the reference API


def _entry_config(tmp_path, which: str) -> ModelConfig:
    d = tmp_path / which
    d.mkdir()
    if which == "demo":
        shutil.copy(REPO / "examples" / "demo_config.yaml", d / "config.yaml")
        shutil.copy(REPO / "examples" / "demo_input_schemas.yaml", d / "input_schemas.yaml")
        shutil.copytree(REPO / "examples" / "demo_data", d / "examples" / "demo_data")
    else:
        shutil.copy(REPO / "examples" / "production_config.yaml", d / "config.yaml")
        shutil.copy(REPO / "examples" / "production_input_schemas.yaml", d / "input_schemas.yaml")
        write_stock_folder(d / "your_data" / "stocks", n_files=3, rows=300, seed=7)
    text = (d / "config.yaml").read_text().replace("device: auto", "device: cpu")
    (d / "config.yaml").write_text(text)
    port_compat.reset_compatibility_layer()
    try:
        return generate.load_config_and_data(str(d))["cfg"]
    finally:
        port_compat.reset_compatibility_layer()


def test_training_flops_per_step_equals_jax(tmp_path):
    cfgs = [_entry_config(tmp_path, "demo"), _entry_config(tmp_path, "production")]
    cfgs += [ModelConfig(**_fixture(name)[1]) for name in NAMES]
    assert cfgs[1].n_embd == 384 and cfgs[1].n_layer == 6 and cfgs[1].num_modalities == 4
    for cfg in cfgs:
        jcfg = JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        for batch in (1, 4, 32):
            assert training_flops_per_step(cfg, batch) == jax_training_flops(jcfg, batch)


BAD_ARGS = [
    dict(batch_size=0), dict(batch_size=-2), dict(batch_size=2.0), dict(batch_size="4"),
    dict(data_size=0), dict(data_size=12.5), dict(block_size=0), dict(block_size=3.0),
    dict(file_lengths=(40, 40)), dict(file_lengths=[]), dict(is_percents=1),
]


@pytest.mark.parametrize("bad", BAD_ARGS, ids=lambda b: "-".join(f"{k}={v!r}" for k, v in b.items()))
def test_generate_batch_starting_indices_rejects_as_jax(bad):
    args = dict(data_size=80, block_size=8, batch_size=4, split="train", file_lengths=[40, 40],
                is_percents=False)
    args.update(bad)
    with pytest.raises(TypeError) as jerr:
        jax_starting_indices(**args, key=jax.random.PRNGKey(0))
    with pytest.raises(TypeError) as err:
        generate_batch_starting_indices(**args, generator=torch.Generator().manual_seed(0))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("is_percents", [False, True])
def test_generate_batch_starting_indices_lie_in_the_valid_set(split, is_percents):
    lengths = [40, 25, 33, 18]
    valid = SplitIndexPlan.build(90, 8, split, lengths, is_percents).valid_start_set()
    for generator in (torch.Generator().manual_seed(1), None):
        starts = generate_batch_starting_indices(90, 8, 256, split, lengths, is_percents, generator)
        assert starts.shape == (256,) and starts.dtype == torch.int64
        assert np.isin(starts.numpy(), valid).all()
    jstarts = np.asarray(jax_starting_indices(90, 8, 256, split, lengths, is_percents,
                                              jax.random.PRNGKey(1)))
    assert np.isin(jstarts, valid).all()


def test_config_accessors_read_legacy_config(tmp_path, monkeypatch):
    """The reference's cached getters resolve through the port's compat
    layer and cache the first read."""
    from trade_aid_multimodal_transformer_tpu_torch.config import accessors

    (tmp_path / "config.py").write_text(
        "batch_size=7\nblock_size=5\nmax_iters=10\neval_interval=5\n"
        "eval_iters=3\nlearning_rate=0.001\ndevice='cpu'\nn_embd=16\n"
        "n_head=2\nn_layer=1\ndropout=0.25\nvalidation_size=0.1\n"
        "num_validation_files=0\ncreate_new_model=1\nsave_model=0\n"
        "model_file_name='m.ckpt'\nproject_file_path='./'\n"
        "output_file_name=''\nfixed_values=[-0.5, 0.5]\n"
        "input_schema_1=None\n"
    )
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    port_compat.reset_compatibility_layer()
    accessors.reset_config_cache()
    try:
        assert accessors._get_batch_size() == 7
        assert accessors._get_block_size() == 5
        assert accessors._get_eval_iters() == 3
        assert accessors._get_n_embd() == 16
        assert accessors._get_n_head() == 2
        assert accessors._get_n_layer() == 1
        assert accessors._get_dropout() == 0.25
        assert accessors._get_device() == "cpu"
        assert accessors._get_fixed_values() == [-0.5, 0.5]
        assert accessors._get_config() is accessors._get_config()  # cached
    finally:
        port_compat.reset_compatibility_layer()
        accessors.reset_config_cache()
        jax_compat.reset_compatibility_layer()


def test_long_tanh_equals_jax_on_a_grid():
    """Equal to the JAX package's wherever XLA's f32 tanh is the correctly
    rounded one; where it is not (it saturates to +-1 from |x| ~ 7.9, where
    tanh rounds to +-0.99999994 up to |x| ~ 9.01), equal to the truncation
    of the correctly rounded tanh, as the reference's ``torch.tanh(x).long()``."""
    x = np.concatenate([np.linspace(-40.0, 40.0, 4001), [0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30]])
    x = x.astype(np.float32)
    got = long_tanh(torch.from_numpy(x))
    assert got.dtype == torch.int64
    want = np.asarray(jax_long_tanh(jnp.asarray(x))).astype(np.int64)
    exact = np.tanh(x.astype(np.float64)).astype(np.float32)
    jax_exact = np.asarray(jnp.tanh(jnp.asarray(x))) == exact
    np.testing.assert_array_equal(got.numpy()[jax_exact], want[jax_exact])
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int64))
    off = np.abs(x[~jax_exact & (want != exact.astype(np.int64))])
    assert off.min() > 7.5 and off.max() < 9.1


def test_fixed_embedding_draws_only_fixed_values():
    fixed = [-0.5, -0.2, 0.0, 0.2, 0.5]
    table = make_fixed_embedding_table(torch.Generator().manual_seed(0), 11, 8, fixed)
    assert table.shape == (11, 8) and table.dtype == torch.float32
    assert np.isin(table.numpy(), np.asarray(fixed, np.float32)).all()
    assert len(np.unique(table.numpy())) > 1
    out = fixed_embedding_lookup(table, torch.tensor([[0, 3], [10, 7]]))
    assert out.shape == (2, 2, 8)
    assert torch.equal(out[0, 0], table[0]) and torch.equal(out[1, 0], table[10])
