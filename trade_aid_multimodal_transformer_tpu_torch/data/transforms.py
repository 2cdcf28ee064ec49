"""Built-in data transforms, vectorized on numpy with bit-exact semantics.

These are the four built-in processing functions of the reference framework
(reference: data_utils.py:212-662), re-implemented as numpy-vectorized host
transforms. Output values must match the reference *exactly* — the sorted set
of transformed values IS the tokenizer vocabulary (reference:
data_utils.py:212-225), so a one-ULP divergence changes token ids.

Exactness notes:
- Decimal rounding uses Python's ``round`` (correctly-rounded decimal
  round-half-even on the binary64 value) applied element-wise after the heavy
  arithmetic is done vectorized. ``np.round`` is *not* equivalent (it rounds
  ``x*10^n`` in binary) and is deliberately not used.
- ``log10``/``pow`` go through the same libm as CPython's ``math`` module, so
  vectorized results match the reference's per-element loop.
- Validation error types/messages are preserved (the reference's quirky
  choices included, e.g. IndexError for non-numeric ranging input;
  reference: data_utils.py:400-402).
- The native C++ helpers (runtime/native.py: decimal rounding, percent
  changes, ranging, bin assignment) take these loops where the library is
  built, as in the JAX package; the numpy/Python paths below stay the
  ground truth and run where it is not (no ``g++``, ``TAT_DISABLE_NATIVE``).
"""

from __future__ import annotations

import numbers
from typing import List, Optional, Sequence, Union

import numpy as np

ArrayLike = Union[Sequence, np.ndarray]

_rng = np.random.default_rng()


def _round_list(values: np.ndarray, dp: int) -> List[float]:
    """Correctly-rounded decimal rounding of a float64 array, as a list.

    Uses the native C++ helper (runtime/native.py, bit-identical to Python
    round) where it is built, else Python round element-wise.
    """
    from ..runtime import native

    out = native.round_decimal(values, dp)
    if out is not None:
        return out.tolist()
    return [round(v, dp) for v in values.tolist()]


def _validate_numeric_list(data, name: str = "data", error_cls=ValueError):
    """Raise when any element is non-numeric, matching reference messages
    (reference: data_utils.py:400-402, 492-494, 634-636)."""
    for i, item in enumerate(data):
        if not isinstance(item, numbers.Number):
            if error_cls is IndexError:
                raise IndexError(
                    f"Element at index {i} in 'numeric_data' is not a number."
                )
            raise ValueError(
                f"All elements in '{name}' must be numeric. "
                f"Element at index {i} is {type(item).__name__}: '{item}'."
            )


def _as_float_array(data, name: str = "data", error_cls=ValueError) -> np.ndarray:
    """Convert to float64, validating numeric-ness like the reference loops do."""
    if isinstance(data, np.ndarray):
        if data.dtype.kind in "ifb":
            return data.astype(np.float64, copy=False)
        _validate_numeric_list(data.tolist(), name, error_cls)
        return data.astype(np.float64)
    arr = np.asarray(data)
    if arr.dtype.kind in "ifb":
        return arr.astype(np.float64, copy=False)
    _validate_numeric_list(list(data), name, error_cls)
    return np.asarray([float(x) for x in data], dtype=np.float64)


# --------------------------------------------------------------------------
# convert_to_percent_changes
# --------------------------------------------------------------------------

def convert_to_percent_changes(data: ArrayLike, decimal_places: Optional[int] = 2) -> List[float]:
    """Backward-looking percent changes, first element pinned to 0.0
    (reference: data_utils.py:612-662).

    Raises ZeroDivisionError on a zero previous value — this is the *strict*
    variant used by the registry/pipeline. The loader applies the lenient
    warn-and-emit-0.0 per-file variant (``percent_changes_lenient``) used on
    the reference's main path (reference: file_cache.py:329-385).
    """
    if (not isinstance(data, (list, np.ndarray))) or len(data) == 0:
        raise ValueError("'data' must be a non-empty list.")
    if decimal_places is not None:
        if not isinstance(decimal_places, int) or decimal_places < 0:
            raise ValueError("'decimal_places' must be a non-negative integer or null.")
    else:
        decimal_places = 2

    arr = _as_float_array(data, "data")
    if arr.size == 1:
        return [0.0]

    from ..runtime import native

    res = native.percent_changes(arr, decimal_places)
    if res is not None:
        out_arr, _, first_zero = res
        if first_zero >= 0:
            raise ZeroDivisionError(
                "Cannot calculate percentage change: previous value is zero at "
                f"index {first_zero}."
            )
        return out_arr.tolist()

    prev = arr[:-1]
    zero_mask = prev == 0
    if zero_mask.any():
        idx = int(np.argmax(zero_mask))
        raise ZeroDivisionError(
            f"Cannot calculate percentage change: previous value is zero at index {idx}."
        )

    changes = ((arr[1:] - prev) / prev) * 100.0
    out = [0.0]
    out.extend(_round_list(changes, decimal_places))
    return out


def percent_changes_lenient(
    data: ArrayLike, decimal_places: int = 2, filename: str = "unknown"
) -> List[float]:
    """Percent changes with graceful zero handling: a zero previous value
    yields 0.0 with a warning, exactly like the cached loader the reference
    uses on its main path (reference: file_cache.py:329-385)."""
    if (not isinstance(data, (list, np.ndarray))) or len(data) == 0:
        raise ValueError(f"'data' must be a non-empty list. File: {filename}")
    if decimal_places is not None:
        if not isinstance(decimal_places, int) or decimal_places < 0:
            raise ValueError(
                f"'decimal_places' must be a non-negative integer or null. File: {filename}"
            )
    else:
        decimal_places = 2

    try:
        arr = _as_float_array(data, "data")
    except ValueError:
        # Find the first offending index for the reference-style message.
        for i, item in enumerate(list(data)):
            try:
                float(item)
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"Non-numeric data encountered at index {i}: {item} in file "
                    f"'{filename}'. Cannot calculate percentage change: {e}"
                )
        raise

    if arr.size == 1:
        return [0.0]

    from ..runtime import native

    def _warn(i):
        print(
            f"Warning: Zero value found at index {i-1} in file '{filename}' causes "
            f"division by zero. Skipping percentage calculation for index {i}. "
            f"Using 0.0% change instead."
        )

    res = native.percent_changes(arr, decimal_places)
    if res is not None:
        out_arr, zmask, _ = res
        for j in np.nonzero(zmask[1:])[0]:
            _warn(int(j) + 1)
        return out_arr.tolist()

    prev = arr[:-1]
    zero_mask = prev == 0
    for j in np.nonzero(zero_mask)[0]:
        _warn(int(j) + 1)

    with np.errstate(divide="ignore", invalid="ignore"):
        changes = ((arr[1:] - prev) / prev) * 100.0
    out = [0.0]
    rounded = _round_list(changes, decimal_places)
    out.extend(
        0.0 if z else r for r, z in zip(rounded, zero_mask.tolist())
    )
    return out


# --------------------------------------------------------------------------
# range_numeric_data
# --------------------------------------------------------------------------

def _decimal_places_of(element) -> int:
    s = str(element)
    if "." in s:
        return len(s.split(".")[-1])
    return 0


def _range_one(element, num_whole_digits, decimal_places):
    """Element-wise ranging, the reference algorithm verbatim in semantics
    (reference: data_utils.py:425-465). Used when ``decimal_places`` is None
    (per-element precision inferred from the printed representation)."""
    import math

    if element == 0:
        power_of_10 = 0
    else:
        power_of_10 = int(math.floor(math.log10(abs(element))))

    apply_dec_places = (
        decimal_places if decimal_places is not None else _decimal_places_of(element)
    )
    apply_dec_places = max(0, apply_dec_places)

    scaling_factor = 1
    if num_whole_digits is not None:
        scaling_factor = 10 ** (num_whole_digits - 1 - power_of_10)

    scaled_value = (
        round(element * scaling_factor, apply_dec_places) if scaling_factor != 0 else 0.0
    )

    if num_whole_digits is not None:
        lower_bound_abs = 10 ** (num_whole_digits - 1)
        upper_bound_abs_compare = 10 ** num_whole_digits
        abs_scaled_value = abs(scaled_value)
        if 0 < abs_scaled_value < lower_bound_abs:
            abs_scaled_value = lower_bound_abs
        if apply_dec_places > 0:
            if abs_scaled_value >= upper_bound_abs_compare:
                abs_scaled_value = upper_bound_abs_compare - (10 ** (-apply_dec_places))
        else:
            if abs_scaled_value >= upper_bound_abs_compare:
                abs_scaled_value = 10 ** num_whole_digits - 1
        scaled_value = abs_scaled_value * (-1 if element < 0 else 1)

    return scaled_value


def range_numeric_data(
    numeric_data: ArrayLike,
    num_whole_digits: Optional[int] = None,
    decimal_places: Optional[int] = None,
) -> List:
    """Scale values to a target whole-digit range and/or round to a decimal
    precision, preserving sign (reference: data_utils.py:361-470).

    The vocabulary-defining math is preserved exactly, including the clip
    rules at the range bounds (reference: data_utils.py:447-462) and the
    quirk that clipped-to-bound values keep the reference's integer type.
    """
    if not isinstance(numeric_data, (list, np.ndarray)):
        raise TypeError("'numeric_data' must be a list.")
    if len(numeric_data) == 0:
        raise TypeError("'numeric_data' must be a non-empty list.")
    if num_whole_digits is not None and not isinstance(num_whole_digits, int):
        raise TypeError("'num_whole_digits' must be an integer or None.")
    if decimal_places is not None and not isinstance(decimal_places, int):
        raise TypeError("'decimal_places' must be an integer or None.")
    if decimal_places is not None and decimal_places < 0:
        raise ValueError("'decimal_places' must be greater than or equal to 0.")

    arr = _as_float_array(numeric_data, "numeric_data", error_cls=IndexError)

    if decimal_places is None:
        # Per-element precision depends on str(element) — inherently scalar.
        src = numeric_data.tolist() if isinstance(numeric_data, np.ndarray) else numeric_data
        return [_range_one(e, num_whole_digits, None) for e in src]

    adp = max(0, decimal_places)
    n = arr.size

    if num_whole_digits is None:
        # Pure rounding path: scaling_factor stays 1.
        return _round_list(arr, adp)

    from ..runtime import native

    res = native.range_numeric(arr, num_whole_digits, adp)
    if res is not None:
        vals, clip_lower_m, clip_upper_m = res
        out = vals.tolist()
        lower = 10 ** (num_whole_digits - 1)
        upper_int = 10 ** num_whole_digits - 1
        neg = arr < 0
        for i in np.nonzero(clip_lower_m)[0]:
            out[i] = -lower if neg[i] else lower
        for i in np.nonzero(clip_upper_m)[0]:
            out[i] = -upper_int if neg[i] else upper_int
        return out

    with np.errstate(divide="ignore", invalid="ignore"):
        powers = np.floor(np.log10(np.abs(arr)))
    powers = np.where(arr == 0.0, 0.0, powers)
    exps = (num_whole_digits - 1) - powers
    scaling = np.power(10.0, exps)
    scaled_raw = arr * scaling

    rounded = _round_list(scaled_raw, adp)
    a = np.abs(np.asarray(rounded, dtype=np.float64))

    lower = 10 ** (num_whole_digits - 1)
    upper = 10 ** num_whole_digits
    mask_lower = (a < lower) & (a > 0)
    a = np.where(mask_lower, float(lower), a)
    if adp > 0:
        mask_upper = a >= upper
        a = np.where(mask_upper, upper - (10 ** (-adp)), a)
        upper_is_int = False
    else:
        mask_upper = a >= upper
        a = np.where(mask_upper, float(upper - 1), a)
        upper_is_int = True

    signs = np.where(arr < 0, -1.0, 1.0)
    out = (a * signs).tolist()

    # The reference assigns python ints at the clip bounds
    # (data_utils.py:448-460: 10**(nwd-1) and 10**nwd - 1 are ints).
    neg = arr < 0
    for i in np.nonzero(mask_lower)[0]:
        out[i] = -lower if neg[i] else lower
    if upper_is_int:
        for i in np.nonzero(mask_upper)[0]:
            out[i] = -(upper - 1) if neg[i] else (upper - 1)

    return out


# --------------------------------------------------------------------------
# bin_numeric_data
# --------------------------------------------------------------------------

def bin_numeric_data(
    data: ArrayLike,
    num_groups: int = None,
    outlier_percentile: float = 5,
    exponent: float = 2.0,
    *,
    num_bins: int = None,
) -> List[int]:
    """Assign values to 2*num_groups+1 symmetric exponentially-spaced bins
    after percentile outlier trimming (reference: data_utils.py:473-609).

    ``num_bins`` is accepted as an alias for ``num_groups``: the reference's
    function signature says num_groups (data_utils.py:473) while its YAML/
    registry contract says num_bins (processing_registry.py:160-173) — a
    mismatch that never surfaced there because the pipeline engine was dead.

    Bin semantics: bin 0 holds exact zeros; positive bins 1..G and negative
    bins -1..-G cover [boundary_low, boundary_high) half-open intervals with
    boundaries ``(i/G)**exponent * max_abs``; values beyond the trimmed range
    land in the outermost bins (the reference's for/else edge handling,
    data_utils.py:534-558).
    """
    if num_groups is None:
        num_groups = num_bins
    if not isinstance(data, (list, np.ndarray)) or len(data) == 0:
        raise ValueError("'data' must be a non-empty list.")
    arr = _as_float_array(data, "data")

    if not isinstance(num_groups, int) or num_groups <= 0:
        raise ValueError("'num_groups' must be a positive integer.")
    if not isinstance(outlier_percentile, (int, float)) or not (0 <= outlier_percentile <= 50):
        raise ValueError("'outlier_percentile' must be a number between 0 and 50.")
    if not isinstance(exponent, (int, float)) or exponent < 1:
        raise ValueError("'exponent' must be a number >= 1.")

    lower_p = np.percentile(arr, outlier_percentile)
    upper_p = np.percentile(arr, 100 - outlier_percentile)
    keep = (arr >= lower_p) & (arr <= upper_p)
    if not keep.any():
        raise ValueError("All data points were filtered out as outliers.")
    filtered = arr[keep]
    max_abs_value = max(abs(float(filtered.min())), abs(float(filtered.max())))

    G = num_groups
    # positive boundaries: [0, (1/G)^e*M, ..., M] — same float ops as the
    # reference's per-i loop (int/int division then float pow then multiply).
    idx = np.arange(1, G + 1, dtype=np.float64) / G
    pos_b = np.concatenate(([0.0], np.power(idx, float(exponent)) * max_abs_value))
    neg_b = np.concatenate((-pos_b[1:][::-1], [0.0]))

    from ..runtime import native

    out = native.bin_assign(arr, pos_b)
    if out is None:
        out = np.zeros(arr.size, dtype=np.int64)
        pos_mask = arr > 0
        neg_mask = arr < 0
        if pos_mask.any():
            g = np.searchsorted(pos_b, arr[pos_mask], side="right")
            out[pos_mask] = np.minimum(g, G)
        if neg_mask.any():
            g = np.searchsorted(neg_b, arr[neg_mask], side="right")
            out[neg_mask] = np.maximum(g - 1, 0) - G

    # --- binning breakdown display (reference: data_utils.py:562-607) ---
    uniq, counts = np.unique(out, return_counts=True)
    group_counts = {int(u): int(c) for u, c in zip(uniq, counts)}

    print(f"    -> Binning breakdown (only populated bins showing):")
    for i in range(-G, 0):
        if i in group_counts:
            j = G + i
            lower_bound = neg_b[j]
            upper_bound = neg_b[j + 1] if j + 1 < len(neg_b) else 0
            count = group_counts[i]
            if i == -G:
                print(f"      Bin {i}: (-inf, {upper_bound:.3f}) - {count} elements")
            else:
                print(f"      Bin {i}: [{lower_bound:.3f}, {upper_bound:.3f}) - {count} elements")
    if 0 in group_counts:
        print(f"      Bin  0: [0.000, 0.000] - {group_counts[0]} elements")
    for i in range(1, G + 1):
        if i in group_counts:
            lower_bound = pos_b[i - 1]
            upper_bound = pos_b[i] if i < len(pos_b) else float("inf")
            count = group_counts[i]
            if i == G:
                print(f"      Bin {i:2d}: [{lower_bound:.3f}, +inf) - {count} elements")
            else:
                print(f"      Bin {i:2d}: [{lower_bound:.3f}, {upper_bound:.3f}) - {count} elements")

    total_assigned = int(counts.sum())
    if total_assigned != len(data):
        print(
            f"      Warning: Total assigned elements ({total_assigned}) != "
            f"input data length ({len(data)})"
        )
    else:
        print(f"      All {len(data)} elements successfully assigned to bins")

    return [int(v) for v in out]


# --------------------------------------------------------------------------
# add_rand_to_data_points (host variant)
# --------------------------------------------------------------------------

def add_rand_to_data_points(
    numeric_data: ArrayLike,
    rand_size: Optional[int],
    vocab_size: int,
    rng: Optional[np.random.Generator] = None,
):
    """±rand_size token-index augmentation, bounds-guarded
    (reference: data_utils.py:293-358).

    A token v is shifted by a uniform draw from {0, ±1, .., ±rand_size} only
    when ``rand_size < v < vocab_size - rand_size`` (strict, matching the
    reference's ``max(rand_list) < v < vocab_size - max(rand_list)`` guard at
    data_utils.py:349). The device-resident per-batch variant used by the
    training hot path lives in sampling/augment.py; this host variant backs
    the processing registry.
    """
    was_ndarray = isinstance(numeric_data, np.ndarray)
    if not isinstance(numeric_data, (list, np.ndarray)):
        raise TypeError("numeric_data must be a list or an array.")
    if len(numeric_data) == 0:
        raise ValueError("numeric_data cannot be empty.")
    if not isinstance(rand_size, (int, type(None))):
        raise TypeError("rand_size must be an integer or null.")
    if rand_size is not None and (rand_size < 1 or rand_size > 3):
        raise ValueError("rand_size must be an integer between 1 and 3, or null.")
    if not isinstance(vocab_size, int) or vocab_size <= 0:
        raise TypeError("vocab_size must be a positive integer.")

    if rand_size is None:
        return numeric_data

    arr = _as_float_array(numeric_data, "numeric_data")
    if not was_ndarray:
        _validate_numeric_list(numeric_data, "numeric_data")

    rng = rng if rng is not None else _rng
    k = rand_size
    mask = (arr > k) & (arr < vocab_size - k)
    shifts = rng.integers(-k, k + 1, size=arr.size)
    shifted = arr + shifts * mask

    if was_ndarray:
        return shifted.astype(numeric_data.dtype)
    return [int(v) if float(v).is_integer() else float(v) for v in shifted.tolist()]
