"""Core numeric ops: streaming STFT, masked-array helpers."""

from . import masked
from .stft import stft_reduce, hann_window, extract_frames, num_frames
