"""Configuration subsystem: schemas, system config, registry, pipeline, compat.

Public surface mirrors the reference's config layer (schema.py,
config_manager.py, processing_registry.py, processing_pipeline.py,
compatibility_layer.py, config_utils.py) so user configs and user code keep
working unchanged. Copies of the JAX package's ``config/`` modules; only
``resolve_device`` differs (config/system.py).
"""

from .compat import (
    CompatibilityMode,
    compatibility_layer,
    get_modality_parameters,
    get_system_configuration,
    initialize_compatibility_layer,
    is_legacy_mode,
    is_modern_mode,
    reset_compatibility_layer,
)
from .pipeline import (
    PipelineResult,
    ProcessingPipeline,
    execute_processing_pipeline,
    validate_schema_pipeline,
)
from .registry import (
    BUILTIN_FUNCTION_VALIDATION,
    get_available_builtin_functions,
    get_function_info,
    register_builtin_function,
    resolve_function,
    unregister_builtin_function,
    validate_function_arguments,
    validate_function_exists,
)
from .schema import (
    InputSchema,
    ProcessingStep,
    SchemaManager,
    convert_legacy_input_schemas,
)
from .system import ConfigManager, SystemConfig, resolve_device

__all__ = [
    "CompatibilityMode",
    "compatibility_layer",
    "get_modality_parameters",
    "get_system_configuration",
    "initialize_compatibility_layer",
    "is_legacy_mode",
    "is_modern_mode",
    "reset_compatibility_layer",
    "PipelineResult",
    "ProcessingPipeline",
    "execute_processing_pipeline",
    "validate_schema_pipeline",
    "BUILTIN_FUNCTION_VALIDATION",
    "get_available_builtin_functions",
    "get_function_info",
    "register_builtin_function",
    "resolve_function",
    "unregister_builtin_function",
    "validate_function_arguments",
    "validate_function_exists",
    "InputSchema",
    "ProcessingStep",
    "SchemaManager",
    "convert_legacy_input_schemas",
    "ConfigManager",
    "SystemConfig",
    "resolve_device",
]
