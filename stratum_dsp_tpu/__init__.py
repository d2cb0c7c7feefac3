"""stratum_dsp_tpu: batch-first music-analysis DSP framework in JAX.

A JAX/XLA implementation of the capabilities of the
stratum-dsp Rust reference (BPM + key + beat grid for DJ applications),
designed batch-first for accelerators: padded [B, T] track batches, static shapes,
masked variable lengths, pjit/shard_map scale-out.
"""

from .config import AnalysisConfig, NormalizationMethod, TemplateSet, DEFAULT_CONFIG
from .errors import (
    AnalysisError,
    DecodingError,
    InvalidInput,
    NotImplementedYet,
    NumericalError,
    ProcessingError,
)
from .result import (
    AnalysisConfidence,
    AnalysisFlag,
    AnalysisMetadata,
    AnalysisResult,
    BeatGrid,
    Key,
    TempoCandidateDebug,
)

__version__ = "0.1.0"
