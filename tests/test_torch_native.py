"""The port's native C++ data transforms (``runtime/native.py``, built from
its own copy of ``runtime/transforms.cpp``) held against the JAX package's
native helpers and against the port's numpy/Python paths, on the CPU.

Tolerance: none. Every output is bit-equal (values, dtypes, masks, indices;
NaN where NaN), since the transformed values are the vocabulary. The
inputs are tests/test_native.py's: random values, half-even decimal ties,
specials, NaN, a zero previous value, and the factorize regimes. Skipped
where there is no ``g++`` (the port then runs its numpy paths alone).
"""

import os
import shutil

import numpy as np
import pytest

from trade_aid_multimodal_transformer_tpu.runtime import native as jax_native
from trade_aid_multimodal_transformer_tpu_torch.data import transforms as T
from trade_aid_multimodal_transformer_tpu_torch.data.ingest import load_and_process_modality
from trade_aid_multimodal_transformer_tpu_torch.data.vocab import numerical_representation
from trade_aid_multimodal_transformer_tpu_torch.runtime import native

from test_torch_host import EXAMPLES, PORT, write_stock_folder  # noqa: E402  (tests/ is on the path)

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not native.available() or not jax_native.available(),
    reason="no g++: the native helpers are not built (both packages take their numpy paths)")


def _ties():
    vals = []
    for k in range(5000):
        v = (k % 997) + 0.005 * (1 + 2 * (k % 9))
        vals += [v, -v, v * 10, v / 10, v + 1e-13, v - 1e-13]
    return np.asarray(vals)


def _zero_prev():
    y = np.random.default_rng(1).uniform(1, 100, 50_000)
    y[1000] = 0.0
    return y


def _bins():
    G = 5
    return np.concatenate(([0.0], np.power(np.arange(1, G + 1) / G, 1.7) * 4.2))


def _ranged():
    rng = np.random.default_rng(2)
    return np.asarray(rng.uniform(-5000, 5000, 20_000).tolist()
                      + [0.0, 0.1, 9.99, 99.96, 100.0, -0.0999, 1e-7, 1e7])


SPECIALS = np.asarray([0.125, 2.675, -2.675, 0.5, 2.5, 1e16, -0.0001, np.inf, -np.inf])
# (function, arguments) of each case: tests/test_native.py's inputs
CASES = {
    **{f"round_random_dp{dp}": ("round_decimal",
                                (np.random.default_rng(0).uniform(-1e4, 1e4, 100_000), dp))
       for dp in (0, 1, 2, 4)},
    "round_ties_half_even": ("round_decimal", (_ties(), 2)),
    "round_specials": ("round_decimal", (SPECIALS, 2)),
    "round_nan": ("round_decimal", (np.asarray([np.nan, 1.005, np.nan]), 2)),
    "percent_zero_mask": ("percent_changes", (_zero_prev(), 2)),
    **{f"range_{nwd}_{dp}": ("range_numeric", (_ranged(), nwd, dp))
       for nwd, dp in ((2, 1), (1, 2), (3, 0))},
    "bin_random": ("bin_assign", (np.concatenate([np.random.default_rng(3).normal(0, 2, 30_000),
                                                  np.zeros(11)]), _bins())),
    "bin_boundaries": ("bin_assign", (np.asarray([1.0, 4.0, -1.0, -4.0, 0.0, 0.5, -0.5, 5.0, -5.0]),
                                      np.asarray([0.0, 1.0, 4.0]))),
    "factorize_rounded": ("factorize", (np.random.default_rng(7).uniform(10, 500, 50_000).round(1),)),
    "factorize_ints": ("factorize",
                       (np.random.default_rng(7).integers(0, 50, 5_000).astype(np.float64),)),
    "factorize_signed_zero": ("factorize", (np.array([3.0, -0.0, 0.0, 3.0, -7.5, 2.25, -7.5]),)),
    "factorize_one": ("factorize", (np.array([1.5]),)),
    "factorize_all_unique": ("factorize", (np.random.default_rng(7).normal(0, 1, 10_000),)),
}


def _equal(a, b) -> bool:
    """Bit-equal results: arrays of one dtype and the same values (NaN where
    NaN), tuples element for element, Python numbers equal."""
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_jax_native(case):
    """Each of the five functions on each input: the port's library and the
    JAX package's give the same bits."""
    fn, args = CASES[case]
    got, want = getattr(native, fn)(*args), getattr(jax_native, fn)(*args)
    assert got is not None and _equal(got, want)


def _numpy_path(fn, args):
    """The numpy/Python ground truth of each native function (the port's
    fallbacks in data/transforms.py and data/vocab.py, written out)."""
    if fn == "round_decimal":
        x, dp = args
        return np.asarray([round(v, dp) for v in x.tolist()])
    if fn == "percent_changes":
        y, dp = args
        prev = y[:-1]
        zero = np.concatenate(([False], prev == 0))
        with np.errstate(divide="ignore", invalid="ignore"):
            ch = ((y[1:] - prev) / prev) * 100.0
        out = [0.0] + [0.0 if z else round(c, dp) for c, z in zip(ch.tolist(), zero[1:])]
        first = int(np.argmax(prev == 0)) if (prev == 0).any() else -1
        return np.asarray(out), zero, first
    if fn == "bin_assign":
        x, pos_b = args
        G = pos_b.size - 1
        neg_b = np.concatenate((-pos_b[1:][::-1], [0.0]))
        out = np.zeros(x.size, dtype=np.int64)
        pos, neg = x > 0, x < 0
        out[pos] = np.minimum(np.searchsorted(pos_b, x[pos], side="right"), G)
        out[neg] = np.maximum(np.searchsorted(neg_b, x[neg], side="right") - 1, 0) - G
        return out
    if fn == "factorize":
        uniq, inverse = np.unique(args[0], return_inverse=True)
        return inverse.astype(np.int32), uniq
    raise KeyError(fn)


@pytest.mark.parametrize("case", sorted(c for c in CASES if not c.startswith("range")))
def test_native_equals_numpy_path(case):
    """Decimal rounding, percent changes (values, zero mask, first zero),
    bin assignment and factorize against the numpy/Python paths they
    replace, bit for bit (ranging: through the transforms below)."""
    fn, args = CASES[case]
    assert _equal(getattr(native, fn)(*args), _numpy_path(fn, args))


@pytest.fixture
def native_off(monkeypatch):
    """A function that runs its argument with the native helper disabled
    (``TAT_DISABLE_NATIVE``), then restores it."""
    def run(fn, *args, **kw):
        with monkeypatch.context() as m:
            m.setenv("TAT_DISABLE_NATIVE", "1")
            m.setattr(native, "_lib", None)
            m.setattr(native, "_tried", False)
            assert not native.available()
            return fn(*args, **kw)
    return run


def _data(seed=4):
    rng = np.random.default_rng(seed)
    data = list(np.round(rng.lognormal(3.0, 1.0, 4000), 3)) + [
        0.0, 0.1, 9.99, 99.96, 100.0, -0.0999, 1e-7, 1e7, -42.5]
    data[5] = 0.0
    return data


TRANSFORMS = {
    "range_2_1": (T.range_numeric_data, dict(num_whole_digits=2, decimal_places=1)),
    "range_1_2": (T.range_numeric_data, dict(num_whole_digits=1, decimal_places=2)),
    "range_3_0": (T.range_numeric_data, dict(num_whole_digits=3, decimal_places=0)),
    "round_only": (T.range_numeric_data, dict(num_whole_digits=None, decimal_places=2)),
    "percent_lenient": (T.percent_changes_lenient, dict(decimal_places=2)),
    "bin": (T.bin_numeric_data, dict(num_bins=6, outlier_percentile=0.1)),
    "vocab": (numerical_representation, {}),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS) + ["percent_strict", "vocab_nan"])
def test_transforms_equal_with_native_on_and_off(name, native_off, capsys):
    """The port's transforms and vocabulary give the same values and types
    (Python ints at the clip bounds, token ids and the vocabulary) and
    print the same lines with the native helper and without it; the strict
    percent changes raise the same error on a zero previous value."""
    data = _data()
    if name == "percent_strict":
        nonzero = [x + 1.0 for x in data]
        assert T.convert_to_percent_changes(nonzero, 2) == native_off(
            T.convert_to_percent_changes, nonzero, 2)
        errors = []
        for run in (lambda f, *a: f(*a), native_off):
            with pytest.raises(ZeroDivisionError) as e:
                run(T.convert_to_percent_changes, data, 2)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
        return
    if name == "vocab_nan":  # NaN takes the numpy path either way
        data = data + [float("nan")]
        fn, kw = numerical_representation, {}
    else:
        fn, kw = TRANSFORMS[name]
    on = fn(data, **kw)
    out_on = capsys.readouterr().out
    off = native_off(fn, data, **kw)
    assert capsys.readouterr().out == out_on
    if name.startswith("vocab"):
        (ids_on, vocab_on), (ids_off, vocab_off) = on, off
        assert ids_on.dtype == ids_off.dtype and np.array_equal(ids_on, ids_off)
        assert np.array_equal(np.asarray(vocab_on), np.asarray(vocab_off), equal_nan=True)
        assert [type(v) for v in vocab_on] == [type(v) for v in vocab_off]
        return
    assert on == off and [type(v) for v in on] == [type(v) for v in off]


def test_ingest_equals_with_native_on_and_off(tmp_path, native_off):
    """The production schemas on synthetic stock CSVs (ranging, percent
    changes with zero prices, binning, raw hours): every modality's values
    and its tokens and vocabulary the same with the native helper and
    without it, and the helper called for each of its five functions."""
    from trade_aid_multimodal_transformer_tpu_torch.config.system import ConfigManager

    write_stock_folder(tmp_path / "your_data" / "stocks", n_files=3, rows=400, seed=9)
    calls = dict.fromkeys(("round_decimal", "percent_changes", "range_numeric", "bin_assign",
                           "factorize"), 0)

    def counted(name, real):
        def fn(*a):
            calls[name] += 1
            return real(*a)
        return fn

    cwd = os.getcwd()
    os.chdir(tmp_path)  # the schemas' paths are relative
    try:
        manager = ConfigManager()
        manager.load_input_schemas(EXAMPLES / "production_input_schemas.yaml")
        for schema in manager.schema_manager.schemas:
            saved = {n: getattr(native, n) for n in calls}
            for n, real in saved.items():
                setattr(native, n, counted(n, real))
            try:
                on = load_and_process_modality(schema, quiet=True)
                ids_on, vocab_on = numerical_representation(on.data)
                T.range_numeric_data(list(on.data[:50]), None, 1)  # the rounding-only path
            finally:
                for n, real in saved.items():
                    setattr(native, n, real)
            off = native_off(load_and_process_modality, schema, quiet=True)
            ids_off, vocab_off = native_off(numerical_representation, off.data)
            assert list(on.data) == list(off.data)
            assert [type(v) for v in on.data] == [type(v) for v in off.data]
            np.testing.assert_array_equal(ids_on, ids_off)
            assert vocab_on == vocab_off
    finally:
        os.chdir(cwd)
    assert all(calls.values()), calls


def test_library_is_the_ports_own():
    """The loaded library is built from the port's transforms.cpp into the
    port's runtime/_build/ (never the JAX package's libtat_transforms.so),
    and ``TAT_DISABLE_NATIVE`` turns it off."""
    assert native.available()
    path = native.library_path()
    assert path.parent == PORT / "runtime" / "_build" and path.exists()
    assert native._lib._name == str(path)
    assert native._SRC == PORT / "runtime" / "transforms.cpp"
