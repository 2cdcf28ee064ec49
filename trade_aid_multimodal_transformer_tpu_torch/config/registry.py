"""Processing-function registry: name → callable resolution + arg validation.

Capability parity with the reference registry
(reference: processing_registry.py:28-269). Built-in names resolve to this
framework's vectorized transforms (data/transforms.py); external functions
are resolved dynamically by fully-qualified ``module.function`` name via
importlib, exactly as the reference documents (README's custom-processing
capability; reference: processing_registry.py:36-82).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List


def _builtin_table() -> Dict[str, Callable]:
    # Imported lazily so the config layer stays importable without the data
    # layer's dependencies.
    from ..data import transforms as T

    return {
        "range_numeric_data": T.range_numeric_data,
        "bin_numeric_data": T.bin_numeric_data,
        "convert_to_percent_changes": T.convert_to_percent_changes,
        "add_rand_to_data_points": T.add_rand_to_data_points,
    }


# Populated on first use; user registrations land here too.
builtin_processing_functions: Dict[str, Callable] = {}


def _ensure_builtins() -> None:
    if not builtin_processing_functions:
        builtin_processing_functions.update(_builtin_table())


def resolve_function(function_name: str) -> Callable:
    """Resolve built-in (simple name) or external (``module.function``) callables
    (reference: processing_registry.py:36-82)."""
    if not function_name or not isinstance(function_name, str):
        raise ValueError(
            f"Function name must be a non-empty string, got: {function_name}"
        )

    _ensure_builtins()
    if function_name in builtin_processing_functions:
        return builtin_processing_functions[function_name]

    try:
        if "." not in function_name:
            raise ImportError(
                f"External function '{function_name}' must be fully qualified "
                "(e.g., 'module.function')"
            )
        module_name, func_name = function_name.rsplit(".", 1)
        module = importlib.import_module(module_name)
        if not hasattr(module, func_name):
            raise AttributeError(f"Module '{module_name}' has no function '{func_name}'")
        function_obj = getattr(module, func_name)
        if not callable(function_obj):
            raise TypeError(f"'{function_name}' is not a callable function")
        return function_obj
    except ImportError as e:
        raise ImportError(f"Failed to import external function '{function_name}': {e}")
    except AttributeError as e:
        raise AttributeError(f"Failed to resolve external function '{function_name}': {e}")
    except TypeError:
        raise
    except Exception as e:
        raise ImportError(f"Unexpected error resolving function '{function_name}': {e}")


def get_available_builtin_functions() -> List[str]:
    _ensure_builtins()
    return list(builtin_processing_functions.keys())


def validate_function_exists(function_name: str) -> bool:
    """True when the function resolves (reference: processing_registry.py:94-107)."""
    try:
        resolve_function(function_name)
        return True
    except (ImportError, AttributeError, ValueError, TypeError):
        return False


def register_builtin_function(name: str, function: Callable) -> None:
    """Register a custom function under a simple name
    (reference: processing_registry.py:110-129)."""
    if not name or not isinstance(name, str):
        raise ValueError("Function name must be a non-empty string")
    if not callable(function):
        raise ValueError("Function must be callable")
    _ensure_builtins()
    if name in builtin_processing_functions:
        print(f"Warning: Overwriting existing built-in function '{name}'")
    builtin_processing_functions[name] = function


def unregister_builtin_function(name: str) -> bool:
    _ensure_builtins()
    if name in builtin_processing_functions:
        del builtin_processing_functions[name]
        return True
    return False


# Per-function argument schemas (reference: processing_registry.py:147-194).
BUILTIN_FUNCTION_VALIDATION: Dict[str, Dict[str, Any]] = {
    "range_numeric_data": {
        "required": [],
        "optional": ["num_whole_digits", "decimal_places"],
        "types": {
            "num_whole_digits": (int, type(None)),
            "decimal_places": (int, type(None)),
        },
        "validators": {
            "num_whole_digits": lambda x: x is None or (isinstance(x, int) and x > 0),
            "decimal_places": lambda x: x is None or (isinstance(x, int) and x >= 0),
        },
    },
    "bin_numeric_data": {
        "required": ["num_bins"],
        "optional": ["outlier_percentile", "exponent"],
        "types": {
            "num_bins": int,
            "outlier_percentile": (int, float),
            "exponent": (int, float),
        },
        "validators": {
            "num_bins": lambda x: isinstance(x, int) and x > 0,
            "outlier_percentile": lambda x: isinstance(x, (int, float)) and 0 <= x <= 100,
            "exponent": lambda x: isinstance(x, (int, float)) and x > 0,
        },
    },
    "convert_to_percent_changes": {
        "required": [],
        "optional": ["decimal_places"],
        "types": {"decimal_places": int},
        "validators": {"decimal_places": lambda x: isinstance(x, int) and x >= 0},
    },
    "add_rand_to_data_points": {
        "required": ["rand_size"],
        "optional": [],
        "types": {"rand_size": int},
        "validators": {"rand_size": lambda x: isinstance(x, int) and 1 <= x <= 3},
    },
}


def validate_function_arguments(function_name: str, args: Dict[str, Any]) -> bool:
    """Validate args for built-ins; external functions pass through
    (reference: processing_registry.py:197-238)."""
    if function_name not in BUILTIN_FUNCTION_VALIDATION:
        return True

    schema = BUILTIN_FUNCTION_VALIDATION[function_name]

    for req_arg in schema["required"]:
        if req_arg not in args:
            raise ValueError(
                f"Missing required argument '{req_arg}' for function '{function_name}'"
            )

    allowed = set(schema["required"] + schema["optional"])
    unknown = set(args.keys()) - allowed
    if unknown:
        raise ValueError(
            f"Unknown arguments for function '{function_name}': {unknown}"
        )

    for arg_name, arg_value in args.items():
        if arg_name in schema["types"]:
            expected = schema["types"][arg_name]
            if not isinstance(arg_value, expected):
                type_name = getattr(expected, "__name__", str(expected))
                raise TypeError(
                    f"Argument '{arg_name}' for function '{function_name}' must be "
                    f"{type_name}, got {type(arg_value).__name__}"
                )
        if arg_name in schema["validators"] and not schema["validators"][arg_name](arg_value):
            raise ValueError(
                f"Invalid value for argument '{arg_name}' in function "
                f"'{function_name}': {arg_value}"
            )
    return True


def get_function_info(function_name: str) -> Dict[str, Any]:
    """Introspect a function by name (reference: processing_registry.py:241-269)."""
    try:
        func = resolve_function(function_name)
        _ensure_builtins()
        return {
            "name": function_name,
            "type": "builtin" if function_name in builtin_processing_functions else "external",
            "callable": callable(func),
            "module": getattr(func, "__module__", "unknown"),
            "doc": getattr(func, "__doc__", "No documentation available"),
            "exists": True,
        }
    except Exception as e:
        return {
            "name": function_name,
            "type": "unknown",
            "callable": False,
            "module": "unknown",
            "doc": "Function not found",
            "exists": False,
            "error": str(e),
        }
