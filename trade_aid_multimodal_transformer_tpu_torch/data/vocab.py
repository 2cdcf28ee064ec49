"""Vocabulary construction and train/val dataset splitting.

Reference semantics: data_utils.py:212-290. The vocabulary is the sorted set
of unique transformed values and doubles as the tokenizer: token id == rank
of the value in the sorted vocabulary.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

ArrayLike = Union[Sequence, np.ndarray]


def numerical_representation(data_points: ArrayLike) -> Tuple[np.ndarray, List]:
    """Map data points to integer token ids over the sorted unique vocabulary
    (reference: data_utils.py:212-225).

    Returns ``(token_ids, vocabulary)`` where token_ids is an int32 array (the
    reference returns a Python list; arrays feed the device-resident sampler)
    and vocabulary is the sorted list of unique values — identical to the
    reference's ``sorted(list(set(data_points)))`` for numeric data.
    """
    arr = np.asarray(data_points)
    if arr.dtype.kind == "f" and not np.isnan(arr).any():
        # Hash-based native factorize: real vocabularies are tiny relative
        # to row count, so O(n) hashing + a sort of just the uniques beats
        # np.unique's O(n log n) argsort over all rows (runtime/transforms
        # .cpp tat_factorize; parity pinned in tests/test_torch_native.py).
        from ..runtime import native

        nat = native.factorize(arr)
        if nat is not None:
            codes, uniq = nat
            return codes, uniq.tolist()
    if arr.dtype.kind in "ifb" or arr.dtype.kind in "US":
        vocab_arr, inverse = np.unique(arr, return_inverse=True)
        return inverse.astype(np.int32), vocab_arr.tolist()

    # Heterogeneous/object data: fall back to the reference's dict mapping.
    vocabulary = sorted(set(data_points))
    mapping = {element: index for index, element in enumerate(vocabulary)}
    ids = np.fromiter(
        (mapping[e] for e in data_points), dtype=np.int32, count=len(data_points)
    )
    return ids, vocabulary


def create_train_val_datasets(
    numeric_rep_data: ArrayLike,
    val_size: float,
    num_val_files: int,
    file_lengths: List[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Split token ids into train/val sets (reference: data_utils.py:228-290).

    Two strategies, exactly as the reference:
    - ``num_val_files > 0``: the last N files form the validation set.
    - otherwise: the trailing ``val_size`` fraction forms the validation set,
      with ``train = int(len * (1 - val_size))`` (truncation, not rounding).

    Both returned splits are int32 arrays (the reference returns the train
    split as a Python list and the val split as a torch tensor — its Quirk
    Q3; here both are device-ready arrays).
    """
    if not isinstance(numeric_rep_data, (list, np.ndarray)):
        raise TypeError("'numeric_rep_data' must be a list.")
    if not isinstance(num_val_files, int) or num_val_files < 0:
        raise TypeError("'num_val_files' must be a non-negative integer.")
    if not isinstance(file_lengths, list) or not all(
        isinstance(length, int) and length > 0 for length in file_lengths
    ):
        raise TypeError("'file_lengths' must be a list of positive integers.")
    if sum(file_lengths) != len(numeric_rep_data):
        raise ValueError(
            f"Sum of file_lengths ({sum(file_lengths)}) does not match length of "
            f"numeric_rep_data ({len(numeric_rep_data)})."
        )

    n = len(numeric_rep_data)
    if num_val_files > 0:
        if num_val_files > len(file_lengths):
            raise ValueError(
                f"'num_val_files' ({num_val_files}) cannot exceed the number of "
                f"loaded files ({len(file_lengths)})."
            )
        val_num_elements = sum(file_lengths[-num_val_files:])
        train_num_elements = n - val_num_elements
    else:
        if not isinstance(val_size, (int, float)) or not (0 < val_size < 1):
            raise ValueError("'val_size' must be a float between 0 and 1 (exclusive).")
        train_num_elements = int(n * (1 - val_size))

    arr = np.asarray(numeric_rep_data, dtype=np.int32)
    return arr[:train_num_elements], arr[train_num_elements:]
