"""The port's host layers (config, ingest, vocab) held against the JAX
package's, and the rule that the port imports nothing of JAX.

The port keeps copies of the JAX package's config/ and data/ modules and of
its native C++ helpers (runtime/, built from the port's own source); these
tests pin that the copies give the same SystemConfig dicts, modality
parameters, token ids and vocabularies, for the demo config and for a
folder of synthetic stock CSVs written here. The AST rule covers every
module of the port (runtime/ and parallel/multihost.py among them) and the
chip scripts. tests/test_torch_native.py holds the native helpers.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

from trade_aid_multimodal_transformer_tpu.config import compat as jax_compat
from trade_aid_multimodal_transformer_tpu.config.system import ConfigManager as JaxConfigManager
from trade_aid_multimodal_transformer_tpu.data import transforms as jax_transforms
from trade_aid_multimodal_transformer_tpu.data.ingest import (
    load_and_process_modality as jax_load_modality,
)
from trade_aid_multimodal_transformer_tpu.data.vocab import (
    numerical_representation as jax_numerical_representation,
)
from trade_aid_multimodal_transformer_tpu_torch import generate as port_generate
from trade_aid_multimodal_transformer_tpu_torch.config import compat as port_compat
from trade_aid_multimodal_transformer_tpu_torch.config.system import ConfigManager
from trade_aid_multimodal_transformer_tpu_torch.data import transforms as port_transforms
from trade_aid_multimodal_transformer_tpu_torch.data.ingest import load_and_process_modality
from trade_aid_multimodal_transformer_tpu_torch.data.vocab import numerical_representation

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "trade_aid_multimodal_transformer_tpu_torch"
EXAMPLES = REPO / "examples"

FOLDER_CONFIG = """\
project_settings:
  project_file_path: "./"
  model_file_name: "output/model.ckpt"
  device: cpu
data_splitting:
  validation_size: 0.1
  num_validation_files: 1
training_parameters:
  batch_size: 4
  block_size: 16
model_architecture:
  n_embd: 32
  n_head: 2
  n_layer: 2
  dropout: 0.0
"""


def write_stock_folder(folder: Path, n_files: int, rows: int, seed: int) -> None:
    """Synthetic per-stock CSVs with a header and 14 columns: hour of day in
    column 6, close in column 13, volume in column 14 (1-based), as the
    production schemas read them."""
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    header = ",".join(f"c{i}" for i in range(1, 15))
    for f in range(n_files):
        close = 40.0 * np.exp(np.cumsum(rng.normal(0.0, 0.01, rows)))
        close[rng.integers(0, rows, 2)] = 0.0  # zero prices hit the lenient percent path
        volume = rng.integers(1_000, 5_000_000, rows)
        hour = 9 + np.arange(rows) % 8
        lines = [header]
        for r in range(rows):
            cols = [f"2024-01-{1 + r % 28:02d}"] + [f"{close[r] * 1.01:.4f}"] * 4
            cols += [str(hour[r])] + ["0"] * 6 + [f"{close[r]:.4f}", str(volume[r])]
            lines.append(",".join(cols))
        (folder / f"stock_{f:02d}.csv").write_text("\n".join(lines) + "\n")


@pytest.fixture
def folder_config(tmp_path):
    write_stock_folder(tmp_path / "your_data" / "stocks", n_files=3, rows=300, seed=7)
    (tmp_path / "config.yaml").write_text(FOLDER_CONFIG)
    (tmp_path / "input_schemas.yaml").write_text(
        (EXAMPLES / "production_input_schemas.yaml").read_text()
    )
    return tmp_path


@pytest.fixture(params=["demo", "folder"])
def config_files(request, folder_config, monkeypatch):
    if request.param == "demo":
        monkeypatch.chdir(REPO)  # the demo's paths are relative to the repo root
        return EXAMPLES / "demo_config.yaml", EXAMPLES / "demo_input_schemas.yaml"
    monkeypatch.chdir(folder_config)
    return folder_config / "config.yaml", folder_config / "input_schemas.yaml"


def test_system_config_and_schemas_match(config_files):
    cfg_path, schemas_path = config_files
    ours, theirs = ConfigManager(), JaxConfigManager()
    for m in (ours, theirs):
        m.load_system_config(cfg_path)
        m.load_input_schemas(schemas_path)
        m.validate_all_functions()
    assert ours.system_config.to_dict() == theirs.system_config.to_dict()
    assert [s.to_legacy_list() for s in ours.schema_manager.schemas] == [
        s.to_legacy_list() for s in theirs.schema_manager.schemas
    ]


def test_ingest_and_vocab_match(config_files):
    _, schemas_path = config_files
    ours, theirs = ConfigManager(), JaxConfigManager()
    ours.load_input_schemas(schemas_path)
    theirs.load_input_schemas(schemas_path)
    for a, b in zip(ours.schema_manager.schemas, theirs.schema_manager.schemas):
        ma, mb = load_and_process_modality(a, quiet=True), jax_load_modality(b, quiet=True)
        assert ma.name == mb.name and list(ma.data) == list(mb.data)
        ids_a, vocab_a = numerical_representation(ma.data)
        ids_b, vocab_b = jax_numerical_representation(mb.data)
        assert vocab_a == vocab_b
        np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))


def test_system_parameters_match_on_cpu(folder_config, monkeypatch):
    """The flat parameter dict of the compatibility layer, for a config that
    names the CPU (both packages resolve it to 'cpu')."""
    monkeypatch.chdir(folder_config)
    try:
        for mod in (port_compat, jax_compat):
            mod.reset_compatibility_layer()
            mod.initialize_compatibility_layer({})
        assert port_compat.get_system_configuration() == jax_compat.get_system_configuration()
        assert port_compat.get_modality_parameters() == jax_compat.get_modality_parameters()
    finally:
        port_compat.reset_compatibility_layer()
        jax_compat.reset_compatibility_layer()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_match_native_backed_originals(seed):
    """The port's transforms (its native helper where built, else its numpy
    paths) against the JAX package's (its own helper or paths). Outputs
    must agree exactly, since the values are the vocabulary."""
    rng = np.random.default_rng(seed)
    data = list(np.round(rng.lognormal(3.0, 1.0, 500), 3))
    data[5] = 0.0
    for fn, kw in [
        ("range_numeric_data", dict(num_whole_digits=2, decimal_places=1)),
        ("range_numeric_data", dict(num_whole_digits=3, decimal_places=0)),
        ("range_numeric_data", dict(num_whole_digits=None, decimal_places=2)),
        ("bin_numeric_data", dict(num_bins=6, outlier_percentile=0.1)),
        ("percent_changes_lenient", dict(decimal_places=2)),
    ]:
        assert getattr(port_transforms, fn)(data, **kw) == getattr(jax_transforms, fn)(data, **kw)
    nonzero = [x + 1.0 for x in data]
    assert port_transforms.convert_to_percent_changes(nonzero, 2) == (
        jax_transforms.convert_to_percent_changes(nonzero, 2)
    )
    with pytest.raises(ZeroDivisionError):
        port_transforms.convert_to_percent_changes(data, 2)


def test_generate_entry_runs_on_the_cpu_when_asked(folder_config, capsys):
    """The port's generate entry on a config that names the CPU: 6 tokens
    within the target vocabulary, the other modalities repeating their last
    prompt token."""
    assert port_generate.main([str(folder_config), "--tokens", "6", "--modality", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 + 6
    res = port_generate.run(str(folder_config), tokens=6, modality=1, seed=3)
    new, vocabs = res["new"], res["vocabs"]
    assert new.shape == (4, 6) and str(res["device"]) == "cpu"
    assert 0 <= new[1].min() and new[1].max() < len(vocabs[1])
    for m in (0, 2, 3):
        assert (new[m] == res["last_prompt_tokens"][m]).all()


def test_generate_entry_serves_on_the_cpu_when_asked(folder_config, capsys):
    """``--serve`` on a config that names the CPU (block_size 16, hs 16: the
    plain cache layout): 20 tokens past a full window in chunks of
    ``--refresh`` 4, within the target vocabulary, the other modalities
    repeating their last prompt token, no kernel launched; int8 needs the
    packed layout and a refresh of block_size is refused, as in the JAX
    package."""
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels

    argv = [str(folder_config), "--tokens", "20", "--modality", "1", "--serve", "--refresh", "4"]
    kernels.reset_launch_counts()
    assert port_generate.main(argv) == 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 + 20
    res = port_generate.run(str(folder_config), tokens=20, modality=1, seed=3, serve=True)
    new, vocabs = res["new"], res["vocabs"]
    assert new.shape == (4, 20) and str(res["device"]) == "cpu"
    assert 0 <= new[1].min() and new[1].max() < len(vocabs[1])
    for m in (0, 2, 3):
        assert (new[m] == res["last_prompt_tokens"][m]).all()
    with pytest.raises(ValueError, match="packed"):
        port_generate.run(str(folder_config), tokens=2, serve=True, kv_dtype="int8")
    with pytest.raises(ValueError, match="refresh"):
        port_generate.main([str(folder_config), "--tokens", "2", "--serve", "--refresh", "16"])


def test_generate_entry_with_auto_device_raises_without_cuda(folder_config, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = folder_config / "config.yaml"
    cfg.write_text(cfg.read_text().replace("device: cpu", "device: auto"))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_generate.run(str(folder_config), tokens=1)


def test_serve_entry_with_auto_device_raises_without_cuda(folder_config, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = folder_config / "config.yaml"
    cfg.write_text(cfg.read_text().replace("device: cpu", "device: auto"))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_generate.main([str(folder_config), "--tokens", "1", "--serve"])


def test_config_without_device_raises_without_cuda(folder_config, monkeypatch):
    """A config.yaml with no device key resolves like auto: the card, and a
    CUDA error without one. Only device: cpu runs on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = folder_config / "config.yaml"
    cfg.write_text(cfg.read_text().replace("  device: cpu\n", ""))
    assert "device" not in cfg.read_text()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_generate.run(str(folder_config), tokens=1)
    manager = ConfigManager()
    manager.load_system_config(cfg)
    assert manager.system_config.device == "auto"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "trade_aid_multimodal_transformer_tpu"


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_compare.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_imports_no_jax(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_rule_covers_the_last_modules():
    """The rule's paths include the port's runtime/ and
    parallel/multihost.py, the modules that replace the JAX package's last
    ones."""
    paths = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"runtime/__init__.py", "runtime/native.py", "parallel/multihost.py"} <= paths
