"""File ingestion: LRU-cached CSV/TXT loading, folder concatenation, and the
main-path percent conversion.

Reference semantics: file_cache.py:14-415 (the cached loader used on the main
path) and data_utils.py:34-160 (the legacy strict loader, kept for API
parity). Multiple modalities typically read different columns of the same
files, so parsed DataFrames are cached with LRU + memory-cap eviction
(reference: file_cache.py:20-37, 183-203).
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Dict, List, Tuple

import numbers
import pandas as pd

from .transforms import convert_to_percent_changes, percent_changes_lenient


class FileCache:
    """LRU + memory-capped cache of parsed DataFrames
    (reference: file_cache.py:14-239)."""

    def __init__(self, max_memory_mb: float = 500.0, max_files: int = 200):
        self.cache: Dict[str, pd.DataFrame] = {}
        self.max_memory_bytes = max_memory_mb * 1024 * 1024
        self.max_files = max_files
        self.access_order: List[str] = []
        self.load_stats = {
            "files_loaded": 0,
            "cache_hits": 0,
            "total_requests": 0,
            "evictions": 0,
        }

    def get_dataframe(self, file_path: str, has_header: bool = True) -> pd.DataFrame:
        normalized_path = os.path.normpath(os.path.abspath(file_path))
        cache_key = f"{normalized_path}_{has_header}"
        self.load_stats["total_requests"] += 1

        if cache_key in self.cache:
            self.load_stats["cache_hits"] += 1
            self.access_order.remove(cache_key)
            self.access_order.append(cache_key)
            return self.cache[cache_key]

        self.load_stats["files_loaded"] += 1
        df = self._load_file(file_path, has_header)
        self._ensure_capacity()
        self.cache[cache_key] = df
        self.access_order.append(cache_key)
        return df

    def _load_file(self, file_path: str, has_header: bool) -> pd.DataFrame:
        """Delimiter fallback chain ',' → ';' → pandas default
        (reference: file_cache.py:74-100)."""
        header = 0 if has_header else None
        for delimiter in [",", ";"]:
            try:
                df = pd.read_csv(file_path, delimiter=delimiter, header=header)
                if len(df.columns) > 1:
                    return df
            except Exception:
                continue
        try:
            return pd.read_csv(file_path, header=header)
        except Exception as e:
            raise RuntimeError(f"Failed to load file {file_path}: {e}")

    def get_column_data(self, file_path: str, column_number: int, has_header: bool = True) -> List:
        """Extract a 1-based column as a Python list
        (reference: file_cache.py:102-125)."""
        df = self.get_dataframe(file_path, has_header)
        col_index = column_number - 1
        if col_index >= len(df.columns):
            raise ValueError(
                f"Column {column_number} does not exist in file {file_path}. "
                f"File has {len(df.columns)} columns."
            )
        return df.iloc[:, col_index].tolist()

    def load_multiple_files(
        self, folder_path: str, column_number: int, has_header: bool = True
    ) -> Tuple[List, List]:
        """Concatenate a column across every CSV/TXT in a folder, sorted by
        path for deterministic ordering (reference: file_cache.py:127-171).

        Returns ``(all_data, file_info)`` with file_info the flat
        ``[name1, len1, name2, len2, ...]`` layout consumed by the
        boundary-aware sampler.
        """
        if not os.path.isdir(folder_path):
            raise ValueError(f"Path {folder_path} is not a directory")

        all_files: List[str] = []
        for pattern in ["*.csv", "*.txt"]:
            all_files.extend(glob.glob(os.path.join(folder_path, pattern)))
        if not all_files:
            raise ValueError(f"No CSV or TXT files found in {folder_path}")
        all_files.sort()

        combined_data: List = []
        file_info: List = []
        for file_path in all_files:
            file_name = os.path.basename(file_path)
            column_data = self.get_column_data(file_path, column_number, has_header)
            combined_data.extend(column_data)
            file_info.extend([file_name, len(column_data)])
        return combined_data, file_info

    def get_cache_stats(self) -> Dict:
        stats = dict(self.load_stats)
        if stats["total_requests"] > 0:
            stats["cache_hit_rate"] = stats["cache_hits"] / stats["total_requests"] * 100
        else:
            stats["cache_hit_rate"] = 0
        stats["cached_files"] = len(self.cache)
        return stats

    def _ensure_capacity(self):
        while len(self.cache) >= self.max_files:
            self._evict_lru()
        current = sum(df.memory_usage(deep=True).sum() for df in self.cache.values())
        while current > self.max_memory_bytes and self.cache:
            self._evict_lru()
            current = sum(df.memory_usage(deep=True).sum() for df in self.cache.values())

    def _evict_lru(self):
        if not self.access_order:
            return
        lru_key = self.access_order.pop(0)
        if lru_key in self.cache:
            del self.cache[lru_key]
            self.load_stats["evictions"] += 1

    def clear_cache(self):
        self.cache.clear()
        self.access_order.clear()
        self.load_stats = {
            "files_loaded": 0,
            "cache_hits": 0,
            "total_requests": 0,
            "evictions": 0,
        }

    def get_memory_usage(self) -> Dict:
        total = 0
        details = {}
        for key, df in self.cache.items():
            mem = df.memory_usage(deep=True).sum()
            total += mem
            details[key] = {
                "rows": len(df),
                "columns": len(df.columns),
                "memory_mb": mem / (1024 * 1024),
            }
        return {
            "total_memory_mb": total / (1024 * 1024),
            "cached_files_count": len(self.cache),
            "file_details": details,
        }


_file_cache = FileCache()


def get_file_cache() -> FileCache:
    return _file_cache


def load_file_data_cached(input_info: List) -> Tuple[List, List]:
    """Main-path loader: cached column extraction + per-file-segment percent
    conversion (reference: file_cache.py:251-326).

    Percent conversion runs per file segment so each file's first element
    resets to 0.0; a zero previous value warns and emits 0.0 rather than
    raising (reference: file_cache.py:298-325, 358-376).
    """
    if not isinstance(input_info, list) or len(input_info) < 10:
        raise ValueError("'input_info' must contain at least 10 elements")

    data_path = input_info[0]
    column_number = input_info[1]
    has_header = input_info[2]
    convert_to_percentages = input_info[3]
    num_dec_places = input_info[5]

    cache = get_file_cache()
    data_name_from_path = Path(data_path).name

    if os.path.isfile(data_path):
        print(f"  Loading data from file: '{data_name_from_path}'")
        column_data = cache.get_column_data(data_path, column_number, has_header)
        file_name = os.path.basename(data_path)
        print(f"    Successfully read file: {file_name}")
        file_info = [file_name, len(column_data)]
        all_data = column_data
    else:
        print(f"    Loading data from folder: '{data_name_from_path}'")
        all_data, file_info = cache.load_multiple_files(data_path, column_number, has_header)
        for i in range(0, len(file_info), 2):
            print(f"    Successfully read file: {file_info[i]}")

    if convert_to_percentages:
        # The falsy check reproduces the reference's `x if x else 2` default
        # (file_cache.py:302,317): decimal_places=0 also falls back to 2.
        dp = num_dec_places if num_dec_places else 2
        if os.path.isfile(data_path):
            all_data = percent_changes_lenient(all_data, dp, data_name_from_path)
        else:
            converted: List = []
            data_index = 0
            for i in range(0, len(file_info), 2):
                file_name = file_info[i]
                file_length = file_info[i + 1]
                segment = all_data[data_index : data_index + file_length]
                converted.extend(percent_changes_lenient(segment, dp, file_name))
                data_index += file_length
            all_data = converted

    return all_data, file_info


def load_file_data(input_info: List) -> Tuple[List, List]:
    """Legacy strict loader: exactly 10 params, strict percent conversion
    (reference: data_utils.py:34-160; dead on the reference's main path but
    part of its public API)."""
    if not isinstance(input_info, list):
        raise TypeError("'input_info' must be a list.")
    if len(input_info) != 10:
        raise ValueError(
            "'input_info' must contain 10 elements: Path, data column number, "
            "header status, convert to percentages status, num whole digits, "
            "num dec places, bin data, rand size, cross-attention status, modality name."
        )

    data_path = input_info[0]
    if not isinstance(data_path, str):
        raise TypeError(
            f"Element 1 (Path) of 'input_info' must be a string, but got "
            f"{type(data_path).__name__}."
        )
    if not os.path.exists(data_path):
        raise FileNotFoundError(f"Path '{data_path}' was not found.")

    num_data_column = input_info[1]
    if not isinstance(num_data_column, int):
        raise TypeError(
            f"Element 2 (data column number) of 'input_info' must be an integer, "
            f"but got {type(num_data_column).__name__}."
        )
    if num_data_column < 1:
        raise ValueError(
            "The specified data column number must be greater than or equal to 1."
        )

    has_header = input_info[2]
    if not isinstance(has_header, bool):
        raise TypeError(
            f"Element 3 (header status) of 'input_info' must be a boolean, but got "
            f"{type(has_header).__name__}."
        )

    convert_to_percentages = input_info[3]
    if not (isinstance(convert_to_percentages, bool) or convert_to_percentages is None):
        raise TypeError(
            f"Element 4 (convert to percentages) of 'input_info' must be a boolean "
            f"or None, but got {type(convert_to_percentages).__name__}."
        )

    modality_name = input_info[9]
    if not (isinstance(modality_name, str) or modality_name is None):
        raise TypeError(
            f"Element 10 (modality name) of 'input_info' must be a string or None, "
            f"but got {type(modality_name).__name__}."
        )

    if os.path.isdir(data_path):
        data_file_paths = sorted(
            os.path.join(data_path, f)
            for f in os.listdir(data_path)
            if os.path.isfile(os.path.join(data_path, f))
            and (f.endswith(".csv") or f.endswith(".txt"))
        )
        if not data_file_paths:
            raise ValueError(f"No CSV or TXT files found in folder '{data_path}'.")
        load_from = "folder"
    elif os.path.isfile(data_path):
        if not (data_path.endswith(".csv") or data_path.endswith(".txt")):
            raise ValueError(f"The specified file '{data_path}' is not a CSV or TXT file.")
        data_file_paths = [data_path]
        load_from = "file"
    else:  # pragma: no cover
        raise FileNotFoundError(f"Path '{data_path}' was not found.")

    loaded_data: List = []
    data_info: List = []
    num_dec_places = input_info[5]
    data_name_from_path = Path(data_path).name
    print(f"  Loading data from {load_from}: '{data_name_from_path}'")

    for full_path in data_file_paths:
        filename = os.path.basename(full_path)
        df = None
        last_error = None
        for delimiter in [",", ";"]:
            try:
                cand = pd.read_csv(
                    full_path,
                    delimiter=delimiter,
                    engine="python",
                    header=None,
                    skiprows=1 if has_header else 0,
                )
                if not cand.empty:
                    df = cand
                    print(f"  Successfully read file: {filename}")
                    break
            except Exception as e:
                last_error = e
        if df is None or df.empty:
            msg = (
                f"Failed to load data from file '{filename}' after trying both comma "
                f"and semicolon delimiters."
            )
            if last_error is not None:
                msg += f" Last error: {last_error}"
            print(msg)
            raise RuntimeError(msg)

        if num_data_column > df.shape[1]:
            raise ValueError(
                f"The specified data column ({num_data_column}) does not exist in "
                f"file '{filename}'. File has {df.shape[1]} columns."
            )

        column_data_list = df.iloc[:, num_data_column - 1].tolist()

        if convert_to_percentages is True:
            if not all(isinstance(x, numbers.Number) for x in column_data_list):
                from .runlog import report_non_numeric_error

                print(
                    f"\nError: Percentage conversion specified for Modality "
                    f"'{modality_name if modality_name else data_name_from_path}' from "
                    f"file '{filename}', but data is not entirely numeric."
                )
                report_non_numeric_error(
                    column_data_list,
                    data_info + [filename, len(column_data_list)],
                    modality_name if modality_name else data_name_from_path,
                )
            loaded_data.extend(
                convert_to_percent_changes(
                    column_data_list, num_dec_places if num_dec_places else 2
                )
            )
        else:
            loaded_data.extend(column_data_list)

        data_info.extend([filename, len(column_data_list)])

    return loaded_data, data_info


def print_cache_stats():
    cache = get_file_cache()
    stats = cache.get_cache_stats()
    memory = cache.get_memory_usage()
    print(
        f"Cache Stats: {stats['cache_hits']}/{stats['total_requests']} hits "
        f"({stats['cache_hit_rate']:.1f}%) | {memory['total_memory_mb']:.1f} MB"
    )


def cleanup_cache():
    """Free the cache after data prep completes (reference: file_cache.py:396-400)."""
    get_file_cache().clear_cache()
