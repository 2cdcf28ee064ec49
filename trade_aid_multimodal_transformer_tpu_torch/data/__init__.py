"""Data subsystem: ingestion, caching, transforms, vocabulary, splitting.

Copies of the JAX package's ``data/`` modules (those the serving path runs),
without its optional native C++ helpers: the numpy paths here are the
semantics that those helpers reproduce.
"""

from .loader import (
    FileCache,
    cleanup_cache,
    get_file_cache,
    load_file_data,
    load_file_data_cached,
    print_cache_stats,
)
from .transforms import (
    add_rand_to_data_points,
    bin_numeric_data,
    convert_to_percent_changes,
    percent_changes_lenient,
    range_numeric_data,
)
from .vocab import create_train_val_datasets, numerical_representation

__all__ = [
    "FileCache",
    "cleanup_cache",
    "get_file_cache",
    "load_file_data",
    "load_file_data_cached",
    "print_cache_stats",
    "add_rand_to_data_points",
    "bin_numeric_data",
    "convert_to_percent_changes",
    "percent_changes_lenient",
    "range_numeric_data",
    "create_train_val_datasets",
    "numerical_representation",
]
